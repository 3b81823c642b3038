"""The port's continuous batcher (eagle_tpu_torch/runtime/scheduler.py) and
the chain engine's batch hooks against the reference's on the CPU.

Both run the same tiny f32 models: a Q8_0 GGUF pair minted with the
reference's writer (`tiny_engine_pair`), loaded by each package's loader
(tests/test_torch_loader.py holds the two loads equal). K = 2 and max_seq 128, as
tests/test_scheduler.py. Each slot's tokens equal the reference batcher's in
every scenario of that file (batched, staggered submission, slot reuse,
chunked prefill interleaving decode, abort, the spec_k override), and the
single-sequence engine's where it asserts that; a sampled row beside a
greedy one gives the reference's tokens when fed the reference's own draws.
Also:

- repairs of the ported chain engine: the greedy cycle caps acceptance at
  each row's spec_k (held with an oracle draft that accepts), the sampler
  rows are written in place, the cycle's branch follows the rows' samplers;
- a masked cycle leaves the inactive rows' tags and scalars bit for bit;
- the rows outside the cache (the draft pair at -1 of a first chunk, a
  prompt ending one token below max_seq) leave every tag as the
  reference's;
- saturation returns None; a prompt that leaves no room raises; slot save,
  restore and resume work."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eagle_tpu.runtime.sampling as jsampling
from eagle_tpu.models.loader import load_eagle_params, load_llama_params
from eagle_tpu.quant.serving import prepare_params_for_serving
from eagle_tpu.runtime.scheduler import ContinuousBatcher as JaxBatcher
from eagle_tpu.runtime.speculative import EagleChainEngine as JaxEngine
from eagle_tpu_torch.models import loader
from eagle_tpu_torch.quant.serving import prepare_params_for_serving as port_serving
from eagle_tpu_torch.runtime import speculative
from eagle_tpu_torch.runtime.sampling import BatchedSamplerParams, SamplerConfig
from eagle_tpu_torch.runtime.scheduler import ContinuousBatcher
from eagle_tpu_torch.runtime.speculative import EagleChainEngine
from torch_port_util import (  # noqa: F401  (background_cpu: a fixture)
    ENGINE_PROMPT,
    background_cpu,
    oracle,
    tiny_engine_pair,
)

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files

K, MAX_SEQ, V = 2, 128, 512
GREEDY = SamplerConfig(greedy=True)
HOT = SamplerConfig(greedy=False, temperature=5.0, top_k=0, top_p=1.0, min_p=0.0)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    target, draft = tiny_engine_pair(tmp_path_factory.mktemp("sched"), ENGINE_PROMPT)
    jt, jcfg, _ = load_llama_params(target)
    jd, jdcfg, _ = load_eagle_params(draft)
    tt, tcfg, _ = loader.load_llama_params(target, device="cpu")
    td, tdcfg, _ = loader.load_eagle_params(draft, device="cpu")
    return dict(jt=prepare_params_for_serving(jt), jd=prepare_params_for_serving(jd),
                jcfg=jcfg, jdcfg=jdcfg, tt=port_serving(tt), td=port_serving(td),
                tcfg=tcfg, tdcfg=tdcfg, ref={}, port={}, chunk={})


def port_engine(m, batch: int, role: str = "batcher") -> EagleChainEngine:
    """One port engine per (batch, role): a batcher resets its state, and
    the single-sequence runs keep their own."""
    if (batch, role) not in m["port"]:
        m["port"][batch, role] = EagleChainEngine(
            m["tt"], m["td"], m["tcfg"], m["tdcfg"], n_draft=K, max_seq=MAX_SEQ, batch=batch,
            kv_dtype=torch.float32, compute_dtype=torch.float32, eos_id=-1, device="cpu")
    return m["port"][batch, role]


def ref_engine(m, batch: int) -> JaxEngine:
    """One reference engine per batch: its compiled programs serve every
    batcher over it."""
    if batch not in m["ref"]:
        m["ref"][batch] = JaxEngine(
            m["jt"], m["jd"], m["jcfg"], m["jdcfg"], n_draft=K, max_seq=MAX_SEQ, batch=batch,
            kv_dtype=jnp.float32, compute_dtype=jnp.float32, backend="xla", eos_id=-1)
    return m["ref"][batch]


def ref_batcher(m, batch: int, chunk: int) -> JaxBatcher:
    """A reference batcher on the module's engine for `batch`. The reference
    jits its prompt-chunk program per batcher, and that program reads
    nothing of the batcher but its engine: every batcher over one engine
    takes the first one's, so the reference compiles it once per module."""
    b = JaxBatcher(ref_engine(m, batch), prefill_chunk=chunk)
    b._chunk_c = m["chunk"].setdefault(batch, b._chunk_c)
    return b


def single(m, prompt, n):
    return port_engine(m, 1, "single").generate(prompt, max_new_tokens=n, stop_at_eos=False)[0][:n]


def prompts(seed: int, *lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(3, V, size=n).tolist() for n in lengths]


# ---- the scenarios of tests/test_scheduler.py, on either batcher


def sc_batched(b, cfg):
    slots = [b.submit(p, max_new_tokens=10, stop_at_eos=False) for p in prompts(1, 5, 11, 8)]
    b.run_until_done(max_steps=100)
    return [s.generated[:10] for s in slots], {"single": [(p, 10) for p in prompts(1, 5, 11, 8)]}


def sc_staggered(b, cfg):
    p1, p2 = prompts(2, 6, 9)
    s1 = b.submit(p1, max_new_tokens=12, stop_at_eos=False)
    for _ in range(2):
        b.step()
    s2 = b.submit(p2, max_new_tokens=8, stop_at_eos=False)
    b.run_until_done(max_steps=100)
    return [s1.generated[:12], s2.generated[:8]], {"single": [(p1, 12), (p2, 8)]}


def sc_reuse(b, cfg):
    (p,) = prompts(3, 5)
    s1 = b.submit(p, max_new_tokens=4, stop_at_eos=False)
    b.run_until_done(max_steps=50)
    assert s1.state == "free"
    s2 = b.submit(p, max_new_tokens=4, stop_at_eos=False)
    b.run_until_done(max_steps=50)
    return [s1.generated, s2.generated[:4]], {"single": [(p, 4), (p, 4)]}


def sc_chunked(b, cfg):
    p_short, p_long = prompts(4, 4, 100)
    s1 = b.submit(p_short, max_new_tokens=20, stop_at_eos=False)
    b.step()  # the short prompt fits one chunk
    assert s1.state == "generating"
    progress = []
    s2 = b.submit(p_long, max_new_tokens=6, stop_at_eos=False)
    for _ in range(7):  # 100 / 16 -> 7 chunks
        n_before = len(s1.generated)
        b.step()
        progress.append(len(s1.generated) - n_before)
    assert sum(progress[:6]) > 0  # decode went on during the long admission
    b.run_until_done(max_steps=100)
    return [s1.generated[:20], s2.generated[:6], progress], {
        "single": [(p_short, 20), (p_long, 6)]}


def sc_abort(b, cfg):
    (p,) = prompts(5, 6)
    s = b.submit(p, max_new_tokens=1000, stop_at_eos=False, request_id="r1")
    for _ in range(3):
        b.step()
    assert s.state == "generating"
    first = list(s.generated)
    assert b.abort("r1") and not b.abort("r1")
    assert s.state == "free" and b.n_active == 0
    s2 = b.submit(p, max_new_tokens=5, stop_at_eos=False)
    b.run_until_done(max_steps=60)
    return [s2.generated[:5], first], {"single": [(p, 5)]}


def sc_spec_k(b, cfg):
    (p,) = prompts(6, 5)
    s = b.submit(p, max_new_tokens=8, stop_at_eos=False, spec_k=0)
    b.step()  # prefill + first cycle
    assert len(s.generated) <= 3
    b.run_until_done(max_steps=100)
    return [s.generated[:8]], {"single": [(p, 8)]}


def sc_samplers(b, cfg):
    """A greedy row beside a hot sampled row (temperature 5, no masks)."""
    p1, p2 = prompts(7, 6, 6)
    s1 = b.submit(p1, max_new_tokens=10, stop_at_eos=False, sampler=cfg(GREEDY))
    s2 = b.submit(p2, max_new_tokens=10, stop_at_eos=False, sampler=cfg(HOT))
    b.run_until_done(max_steps=100)
    assert len(s2.generated) == 10
    return [s1.generated[:10], s2.generated[:10]], {"single": [(p1, 10)]}


SCENARIOS = {  # name -> (function, batch, prefill chunk)
    "batched": (sc_batched, 4, 64), "staggered": (sc_staggered, 2, 64),
    "reuse": (sc_reuse, 2, 64), "chunked": (sc_chunked, 2, 16), "abort": (sc_abort, 1, 64),
    "spec_k": (sc_spec_k, 1, 64), "samplers": (sc_samplers, 2, 64),
}


class FedRNG:
    """The port engine's random source fed the reference batcher's draws:
    its key starts at PRNGKey(0) and splits once per prompt chunk and once
    per cycle; a chunk draws Gumbel noise for its one row, a cycle the
    Gumbel noise of its K draft draws and of the correction, then the
    acceptance uniforms (`sampling.speculative_accept`'s ukey / ckey)."""

    def __init__(self, b: int):
        self.key, self.b, self.queue = jax.random.PRNGKey(0), b, []
        self.seed = self.counter = torch.zeros((), dtype=torch.int64)  # graph keys

    def chunk(self):
        self.key, sub = jax.random.split(self.key)
        self.queue = [jax.random.gumbel(sub, (1, V))]

    def cycle(self):
        self.key, sub = jax.random.split(self.key)
        dkeys = jax.random.split(sub, K + 1)
        ukey, ckey = jax.random.split(dkeys[K])
        g = [jax.random.gumbel(k, (self.b, V)) for k in dkeys[:K]]
        self.queue = [jnp.stack(g + [jax.random.gumbel(ckey, (self.b, V))]),
                      jax.random.uniform(ukey, (self.b, K))]

    def _next(self, shape):
        x = torch.from_numpy(np.array(self.queue.pop(0)))
        assert tuple(x.shape) == tuple(shape), (x.shape, shape)
        return x

    gumbel = uniform = _next


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_batcher_matches_reference(models, name, monkeypatch):
    fn, batch, chunk = SCENARIOS[name]
    want, _ = fn(ref_batcher(models, batch, chunk),
                 lambda c: jsampling.SamplerConfig(**dataclasses.asdict(c)))
    eng = port_engine(models, batch)
    batcher = ContinuousBatcher(eng, prefill_chunk=chunk)
    fed = FedRNG(batch)
    real_chunk, real_cycles = eng._prefill_chunk, eng._multi_cycle
    monkeypatch.setattr(eng.state, "rng", fed)
    monkeypatch.setattr(eng, "_prefill_chunk", lambda *a: (fed.chunk(), real_chunk(*a))[1])
    monkeypatch.setattr(eng, "_multi_cycle", lambda *a, **k: (fed.cycle(), real_cycles(*a, **k))[1])
    got, extra = fn(batcher, lambda c: c)
    assert got == want
    for toks, (p, n) in zip(got, extra["single"]):
        assert toks == single(models, p, n)


def test_saturation_returns_none(models):
    b = ContinuousBatcher(port_engine(models, 1))
    (p,) = prompts(8, 4)
    assert b.submit(p, max_new_tokens=20, stop_at_eos=False) is not None
    assert b.submit(p, max_new_tokens=20, stop_at_eos=False) is None


@pytest.mark.parametrize("n", [0, MAX_SEQ])
def test_prompt_without_room_is_refused(models, n):
    b = ContinuousBatcher(port_engine(models, 1))
    with pytest.raises(ValueError, match="does not fit"):
        b.submit([5] * n, max_new_tokens=4)


@pytest.mark.parametrize("call", ["save_slot", "restore_slot", "resume_slot"])
def test_slot_state_io_names_its_item(models, call, tmp_path):
    """Slot save / restore / resume, which refused before runtime/state_io.py
    was ported, work: the save holds the slot's progress, the restore
    brings back its tags and counters into a paused slot, and the resumed
    slot goes on with the single-sequence engine's tokens."""
    b = ContinuousBatcher(port_engine(models, 1))
    (p,) = prompts(8, 5)
    s = b.submit(p, max_new_tokens=4, stop_at_eos=False)
    b.run_until_done(max_steps=20)
    first, tags = list(s.generated), b.state.tgt_kv.slot_pos.clone()
    extra = b.save_slot(0, tmp_path / "slot.bin")
    assert extra == {"generated": first, "prompt_len": 5, "max_new": 4, "stop_at_eos": False}
    if call == "save_slot":
        return
    b.state.tgt_kv.slot_pos.fill_(-1)
    r = b.restore_slot(tmp_path / "slot.bin")
    assert r is s and r.state == "restored" and r.generated == first
    assert torch.equal(b.state.tgt_kv.slot_pos, tags) and b.n_active == 0
    if call == "restore_slot":
        return
    b.resume_slot(0, max_new_tokens=12)
    b.run_until_done(max_steps=40)
    assert s.generated[:12] == single(models, p, 12)


# ---- the repairs of the chain engine


def _greedy_seq(m, prompt, n=40):
    return torch.tensor(prompt + single(m, prompt, n), dtype=torch.int64)


@pytest.mark.parametrize("spec_k", [0, 1])
def test_greedy_cycle_caps_acceptance_at_spec_k(models, spec_k, monkeypatch):
    """Repair 1: with an oracle draft the uncapped row accepts every draft,
    the capped row at most spec_k per cycle; both keep the greedy tokens."""
    (p,) = prompts(9, 7)
    seq = _greedy_seq(models, p)
    monkeypatch.setattr(speculative, "eagle_forward", oracle(speculative.eagle_forward, seq))
    eng = port_engine(models, 2)
    b = ContinuousBatcher(eng)
    capped = b.submit(p, max_new_tokens=16, stop_at_eos=False, spec_k=spec_k)
    free = b.submit(p, max_new_tokens=16, stop_at_eos=False)
    b.step()
    acc = []
    while b.n_active:
        b.step()
        acc.append(eng._outs[1].n_accepted[0].tolist())
    assert max(a[capped.id] for a in acc) == spec_k
    assert max(a[free.id] for a in acc) == K
    assert capped.generated == free.generated == seq[len(p):len(p) + 16].tolist()


def test_sampler_rows_are_written_in_place(models):
    """Repair 2: set_row keeps every tensor's address (the graphs hold them)."""
    bs = BatchedSamplerParams.create(3, GREEDY, n_draft=K)
    before = [t.data_ptr() for t in bs.tensors()]
    assert bs.set_row(1, HOT, spec_k=1) is bs
    assert [t.data_ptr() for t in bs.tensors()] == before
    assert torch.equal(bs.temperature, torch.tensor([GREEDY.temperature, 5.0, GREEDY.temperature]))
    assert bs.greedy.tolist() == [True, False, True] and bs.spec_k.tolist() == [K, 1, K]


def test_cycle_branch_follows_the_rows_samplers(models):
    """Repair 3: the all-greedy flag is recomputed from the rows, and the
    cycle's graph key carries it."""
    eng = EagleChainEngine(models["tt"], models["td"], models["tcfg"], models["tdcfg"],
                           n_draft=K, max_seq=MAX_SEQ, batch=2, kv_dtype=torch.float32,
                           compute_dtype=torch.float32, device="cpu")
    assert eng.fast_greedy
    eng.set_row_sampler(1, HOT)
    assert not eng.fast_greedy
    b = ContinuousBatcher(eng)
    for p in prompts(10, 5, 6):
        b.submit(p, max_new_tokens=4, stop_at_eos=False, sampler=HOT)
    b.run_until_done(max_steps=20)
    assert eng._q is not None  # the stochastic branch ran
    eng.set_row_sampler(0, GREEDY)
    eng.set_row_sampler(1, GREEDY)
    assert eng.fast_greedy


# ---- the freeze and the rows outside the cache


def test_masked_cycle_freezes_inactive_rows(models):
    """Rows 0 (mid-prefill) and 2 (parked) keep their tags, last token,
    feature and n_past bit for bit across cycles; row 1 generates."""
    eng = port_engine(models, 3)
    b = ContinuousBatcher(eng, prefill_chunk=16)
    short, long_ = prompts(11, 5, 70)
    b.submit(short, max_new_tokens=30, stop_at_eos=False)
    b.step()
    b.submit(long_, max_new_tokens=4, stop_at_eos=False)
    st = eng.state
    for _ in range(3):
        b._advance_prefill()  # chunks of row 1, then cycles with row 1 inactive
        frozen = [t[[1, 2]].clone() for t in (st.tgt_kv.slot_pos, st.dft_kv.slot_pos,
                                              st.last_token, st.feature, st.n_past)]
        n_before = st.n_past[0].item()
        eng._multi_cycle(1, kv_limit=MAX_SEQ, active=b._active_mask)
        assert st.n_past[0].item() > n_before
        for old, t in zip(frozen, (st.tgt_kv.slot_pos, st.dft_kv.slot_pos, st.last_token,
                                   st.feature, st.n_past)):
            assert t[[1, 2]].numpy().tobytes() == old.numpy().tobytes()


@pytest.mark.parametrize("case", ["first_chunk", "max_seq_edge"])
def test_rows_outside_the_cache_keep_the_reference_tags(models, case):
    """A first chunk's draft pair sits at position -1; a prompt of
    max_seq - 1 tokens runs a cycle whose rows pass the cache. Tags (the
    reference's [B, S], the port's first S columns) and the first token
    equal the reference's after the prefill and after the cycle; the slot
    is then recycled by the overflow guard."""
    n = 20 if case == "first_chunk" else MAX_SEQ - 1
    (p,) = prompts(12, n)
    jb = ref_batcher(models, 2, 16)
    b = ContinuousBatcher(port_engine(models, 2), prefill_chunk=16)
    slots = []
    for bt in (jb, b):
        bt.submit(prompts(13, 9)[0], max_new_tokens=3, stop_at_eos=False)
        bt.run_until_done(max_steps=20)  # the row has a previous request's tags
        slots.append(bt.submit(p, max_new_tokens=50, stop_at_eos=False))
    for step in range(-(-n // 16) + 1):
        jb.step()
        b.step()
        for kv in ("tgt_kv", "dft_kv"):
            want = np.asarray(getattr(jb.state, kv).slot_pos)
            got = getattr(b.state, kv).slot_pos[:, :MAX_SEQ].numpy()
            np.testing.assert_array_equal(got, want, err_msg=f"{kv} step {step}")
    assert slots[1].generated[0] == slots[0].generated[0]
    if case == "max_seq_edge":
        assert slots[0].state == slots[1].state == "free"
