"""One dispatch per decode step or group of EAGLE cycles (eagle_tpu_torch/
runtime/graphs.py and the engines' in-place bodies) on the CPU, where the
bodies run eagerly: the same functions the card captures and replays.

- The port's `EagleChainEngine.generate(cycles_per_dispatch=4)` equals its
  C = 1 run and the reference's C = 4 run (`backend="xla"`, f32), with the
  reference's stats, for a plain run, the wind-down near max_seq = 32 and
  eos in the middle of a dispatch (as tests/test_speculative.py's
  `test_multi_cycle_dispatch_token_identity`); with an oracle draft, the
  cycles after a stop are computed and left out of the stats.
- One engine's state is reset in place: two `generate` calls give the same
  tokens on the same tensors.
- `Generator` chunks of 1, 3 and 32 steps give the same tokens.
- `StepGraphs`' replay counting, with the capture stubbed: a replayed body
  counts in `_build.launches` as an eager one does."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.models.synth import synth_eagle_params, synth_llama_params
from eagle_tpu.runtime.speculative import EagleChainEngine as JaxEngine
from eagle_tpu_torch import _build
from eagle_tpu_torch.convert import params_from_numpy
from eagle_tpu_torch.runtime import graphs
from eagle_tpu_torch.runtime.generate import Generator
from eagle_tpu_torch.runtime.speculative import EagleChainEngine
from torch_port_util import (  # noqa: F401  (background_cpu: a fixture)
    background_cpu, tiny_cfgs, tree_to_numpy,
)

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files

K = 2  # drafts per cycle, as the reference's test


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = tiny_cfgs()
    jt = synth_llama_params(jcfg, seed=0, on_device=True, packed=True, coded=True)
    jd = synth_eagle_params(dataclasses.replace(jcfg, n_layers=1, is_eagle=True), packed=True)
    tt = params_from_numpy(tree_to_numpy(jt), "cpu")
    td = params_from_numpy(tree_to_numpy(jd), "cpu")
    prompt = np.random.default_rng(7).integers(0, jcfg.vocab_size, size=11).tolist()
    return jcfg, tcfg, jt, jd, tt, td, prompt


def _port(setup, max_seq=128, eos_id=-1, n_draft=K):
    _, tcfg, _, _, tt, td, _ = setup
    return EagleChainEngine(tt, td, tcfg, n_draft=n_draft, max_seq=max_seq,
                            kv_dtype=torch.float32, compute_dtype=torch.float32,
                            eos_id=eos_id, device="cpu")


# case -> (max_seq, max_new_tokens, stop_at_eos)
CASES = {"plain": (128, 40, False), "wind_down": (32, 64, False), "eos": (128, 40, True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_multi_cycle_dispatch_matches_single_and_reference(setup, case):
    jcfg, _, jt, jd, _, _, prompt = setup
    max_seq, max_new, stop = CASES[case]
    eos = -1
    if case == "eos":  # an eos id the model emits inside the first dispatch
        eos = _port(setup).generate(prompt, max_new_tokens=max_new, stop_at_eos=False)[0][2]
    base, st1 = _port(setup, max_seq, eos).generate(prompt, max_new_tokens=max_new,
                                                     stop_at_eos=stop)
    eng4 = _port(setup, max_seq, eos)
    got, st4 = eng4.generate(prompt, max_new_tokens=max_new, stop_at_eos=stop,
                             cycles_per_dispatch=4)
    ref = JaxEngine(jt, jd, jcfg, n_draft=K, max_seq=max_seq, kv_dtype=jnp.float32,
                    compute_dtype=jnp.float32, backend="xla", eos_id=eos)
    want, ref_st = ref.generate(prompt, max_new_tokens=max_new, stop_at_eos=stop,
                                cycles_per_dispatch=4)
    assert got == base == want
    assert st4 == st1 == ref_st
    # emitted-token accounting: overshoot cycles are not counted
    assert st4["n_accepted"] + st4["n_cycles"] >= len(got) - 1
    assert eng4.cycles_run >= st4["n_cycles"]
    if case == "eos":  # stopped inside the first dispatch; its later cycles discarded
        assert got[-1] == eos and eos not in got[:-1]
        assert eng4.cycles_run == 4 > st4["n_cycles"]
    if case == "wind_down":  # single cycles until the next one would not fit
        assert len(got) < max_new
        assert len(prompt) + len(got) - 1 + K + 2 >= max_seq


def test_multi_cycle_overshoot_left_out_of_stats(setup, monkeypatch):
    """An oracle draft proposes the target's own greedy tokens, so cycles
    emit K + 1 tokens: max_new is reached in the middle of the second
    4-cycle dispatch; the cycle after it is computed, discarded, and the
    tokens and stats equal the C = 1 run's."""
    from eagle_tpu_torch.runtime import speculative

    _, _, _, _, _, _, prompt = setup
    want, _ = _port(setup).generate(prompt, max_new_tokens=24, stop_at_eos=False)
    seq = list(prompt) + want
    real = speculative.eagle_forward

    def oracle(*args, **kw):
        out = real(*args, **kw)
        if out.logits is None:
            return out
        pos = int(args[5][0, 0])  # pair at draft position p proposes x_{p+2}
        logits = torch.zeros_like(out.logits)
        logits[..., seq[min(pos + 2, len(seq) - 1)]] = 1.0
        return out._replace(logits=logits)

    monkeypatch.setattr(speculative, "eagle_forward", oracle)
    runs = {}
    for c in (1, 4):
        eng = _port(setup)
        toks, stats = eng.generate(prompt, max_new_tokens=20, stop_at_eos=False,
                                   cycles_per_dispatch=c)
        runs[c] = (toks, stats, eng.cycles_run)
    assert runs[1][0] == runs[4][0] == want[:20]
    assert runs[1][1] == runs[4][1]
    assert runs[4][1]["n_cycles"] == 7 and runs[4][1]["n_accepted"] == K * 7
    assert runs[1][2] == 7 and runs[4][2] == 8  # the 8th cycle: overshoot


def test_engine_state_reset_in_place(setup):
    """Two `generate` calls on one engine, with another prompt between,
    give the same tokens and stats, on the same state tensors."""
    _, _, _, _, _, _, prompt = setup
    eng = _port(setup)
    ptrs = [t.data_ptr() for t in (eng.state.tgt_kv.k, eng.state.dft_kv.slot_pos,
                                   eng.state.feature, eng.state.n_past)]
    first = eng.generate(prompt, max_new_tokens=16, stop_at_eos=False, cycles_per_dispatch=4)
    eng.generate(prompt[::-1] + prompt, max_new_tokens=24, stop_at_eos=False)
    again = eng.generate(prompt, max_new_tokens=16, stop_at_eos=False, cycles_per_dispatch=4)
    assert again == first
    assert ptrs == [t.data_ptr() for t in (eng.state.tgt_kv.k, eng.state.dft_kv.slot_pos,
                                           eng.state.feature, eng.state.n_past)]
    assert not eng.graphs.enabled and eng.graphs.replays == 0
    assert eng.graphs.eager > 0  # every dispatch ran its body eagerly


def test_generator_chunk_lengths_identical(setup):
    """Chunks of 1, 3 and 32 steps give the same tokens; on the CPU every
    step is an eager body (the prefill's token needs none)."""
    _, tcfg, _, _, tt, _, prompt = setup
    toks = {}
    for chunk in (1, 3, 32):
        gen = Generator(tt, tcfg, max_seq=128, kv_dtype=torch.float32,
                        compute_dtype=torch.float32, eos_id=-1, device="cpu")
        toks[chunk] = gen.generate(prompt, max_new_tokens=21, stop_at_eos=False, chunk=chunk)
        assert not gen.graphs.enabled
        assert gen.graphs.eager == 20 and gen.graphs.replays == 0
    assert toks[1] == toks[3] == toks[32]
    assert len(toks[1]) == 21
    with pytest.raises(ValueError, match="leave the cache"):
        gen._decode_chunk(torch.zeros(1, dtype=torch.int32), 120, None, 9)


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):  # a graph replays device work: no Python runs
        self.replays += 1


@pytest.fixture
def stub_capture(monkeypatch):
    """StepGraphs with the CUDA warm-up and capture stubbed: warm-up runs the
    body, capture runs it too (its counts must not stay) and returns a fake
    graph."""
    made = []

    def capture(self, body):
        body()
        made.append(_FakeGraph())
        return made[-1]

    monkeypatch.setattr(graphs.StepGraphs, "_warm_up", lambda self, body: body())
    monkeypatch.setattr(graphs.StepGraphs, "_capture", capture)
    monkeypatch.delenv("EAGLE_TPU_FUSED_FFN", raising=False)
    _build.reset_counts()
    yield made
    _build.reset_counts()


def _body():
    _build.launches["qmm_gemv"] += 3
    _build.launches["flash_decode"] += 1


def test_step_graphs_count_replays(stub_capture):
    g = graphs.StepGraphs(enabled=True)
    static = [torch.zeros(4), torch.zeros(2, dtype=torch.int32)]
    g.run(("step", 128), _body, static)  # warm-up (a real step) + capture
    assert (g.eager, g.captures, g.replays) == (1, 1, 0)
    assert _build.launches["qmm_gemv"] == 3 and _build.launches["flash_decode"] == 1
    for _ in range(5):
        g.run(("step", 128), _body, static)
    assert (g.eager, g.captures, g.replays) == (1, 1, 5)
    assert len(stub_capture) == 1 and stub_capture[0].replays == 5
    assert _build.launches["qmm_gemv"] == 3 * 6 and _build.launches["flash_decode"] == 6
    assert sum(_build.plain_calls.values()) == 0


def test_step_graphs_keys(stub_capture, monkeypatch):
    """Another static key or fused-FFN mode takes its own graph, and the
    first one is replayed again after; a replaced tensor recaptures."""
    g = graphs.StepGraphs(enabled=True)
    static = [torch.zeros(4)]
    g.run(("step", 128), _body, static)
    g.run(("step", 256), _body, static)
    monkeypatch.setenv("EAGLE_TPU_FUSED_FFN", "1")
    g.run(("step", 128), _body, static)
    monkeypatch.delenv("EAGLE_TPU_FUSED_FFN")
    g.run(("step", 128), _body, static)
    assert (g.captures, g.replays) == (3, 1) and stub_capture[0].replays == 1
    g.run(("step", 128), _body, [torch.zeros(4)])  # a new cache: stale graph dropped
    assert (g.eager, g.captures, g.replays) == (4, 4, 1)
    g.run(("step", 128), _body, static)  # and the old tensors recapture again
    assert (g.eager, g.captures) == (5, 5)
    assert _build.launches["qmm_gemv"] == 3 * (5 + 1)
