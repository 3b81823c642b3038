"""The slice as a whole: the port's greedy `Generator` and `EagleChainEngine`
against the JAX package's (its `backend="xla"` path) on the same synthetic
Q4_K packed, coded target and packed draft, f32 compute and f32 KV cache.

Token sequences must be identical: port greedy == reference greedy, and the
port's chain engine == the port's greedy == the reference engine, with
`n_cycles` and `n_accepted` equal to the reference's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.models.synth import synth_eagle_params, synth_llama_params
from eagle_tpu.runtime.generate import Generator as JaxGenerator
from eagle_tpu.runtime.speculative import EagleChainEngine as JaxEngine
from eagle_tpu_torch.convert import params_from_numpy
from eagle_tpu_torch.runtime.generate import Generator
from eagle_tpu_torch.runtime.speculative import EagleChainEngine
from torch_port_util import (  # noqa: F401  (background_cpu: a fixture)
    background_cpu, tiny_cfgs, tree_to_numpy,
)

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files

MAX_SEQ = 128
N_NEW = 20


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = tiny_cfgs()
    jt = synth_llama_params(jcfg, seed=0, on_device=True, packed=True, coded=True)
    jd = synth_eagle_params(dataclasses.replace(jcfg, n_layers=1, is_eagle=True), packed=True)
    tt = params_from_numpy(tree_to_numpy(jt), "cpu")
    td = params_from_numpy(tree_to_numpy(jd), "cpu")
    prompt = np.random.default_rng(5).integers(0, jcfg.vocab_size, size=11).tolist()
    ref_plain = JaxGenerator(jt, jcfg, max_seq=MAX_SEQ, kv_dtype=jnp.float32,
                             compute_dtype=jnp.float32, backend="xla", eos_id=-1)
    want = ref_plain.generate(prompt, max_new_tokens=N_NEW, stop_at_eos=False, chunk=8)
    return jcfg, tcfg, jt, jd, tt, td, prompt, want


def _port_greedy(tcfg, tt, prompt):
    gen = Generator(tt, tcfg, max_seq=MAX_SEQ, kv_dtype=torch.float32,
                    compute_dtype=torch.float32, eos_id=-1, device="cpu")
    return gen.generate(prompt, max_new_tokens=N_NEW, stop_at_eos=False, chunk=8)


def test_greedy_tokens_identical(setup):
    _, tcfg, _, _, tt, _, prompt, want = setup
    assert _port_greedy(tcfg, tt, prompt) == want


@pytest.mark.parametrize("feature_source", ["post_norm", "pre_norm"])
@pytest.mark.parametrize("n_draft", [1, 3])
def test_chain_engine_identical(setup, n_draft, feature_source):
    jcfg, tcfg, jt, jd, tt, td, prompt, want = setup
    ref = JaxEngine(jt, jd, jcfg, n_draft=n_draft, max_seq=MAX_SEQ, kv_dtype=jnp.float32,
                    compute_dtype=jnp.float32, backend="xla", feature_source=feature_source,
                    eos_id=-1)
    ref_toks, ref_stats = ref.generate(prompt, max_new_tokens=N_NEW, stop_at_eos=False)
    eng = EagleChainEngine(tt, td, tcfg, n_draft=n_draft, max_seq=MAX_SEQ,
                           kv_dtype=torch.float32, compute_dtype=torch.float32,
                           feature_source=feature_source, eos_id=-1, device="cpu")
    got, stats = eng.generate(prompt, max_new_tokens=N_NEW, stop_at_eos=False)
    assert got == ref_toks == want
    assert stats["n_cycles"] == ref_stats["n_cycles"]
    assert stats["n_accepted"] == ref_stats["n_accepted"]
    assert stats["n_cycles"] > 0


def test_chain_engine_accept_all(setup, monkeypatch):
    """An oracle draft that proposes the target's own greedy tokens: every
    full cycle accepts all K drafts, and the output still equals plain
    greedy decoding (exercises acceptance > 0, rollback and the feature
    handoff at index K)."""
    from eagle_tpu_torch.runtime import speculative

    _, tcfg, _, _, tt, td, prompt, want = setup
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
    k = 4
    eng = EagleChainEngine(tt, td, tcfg, n_draft=k, max_seq=MAX_SEQ, kv_dtype=torch.float32,
                           compute_dtype=torch.float32, eos_id=-1, device="cpu")
    got, stats = eng.generate(prompt, max_new_tokens=N_NEW, stop_at_eos=False)
    assert got == want
    assert stats["n_accepted"] == stats["n_drafted"] == k * stats["n_cycles"]
    assert stats["mean_accept_len"] == k + 1


def test_generator_reuse_and_eos(setup):
    """A reused Generator invalidates the previous tags (same tokens again),
    and generation stops at eos."""
    _, tcfg, _, _, tt, _, prompt, want = setup
    gen = Generator(tt, tcfg, max_seq=MAX_SEQ, kv_dtype=torch.float32,
                    compute_dtype=torch.float32, eos_id=want[3], device="cpu")
    assert gen.generate(prompt, max_new_tokens=N_NEW, stop_at_eos=False, chunk=8) == want
    stopped = gen.generate(prompt, max_new_tokens=N_NEW, chunk=8)
    assert stopped == want[: want.index(want[3]) + 1]
