"""The port's `llama_forward` and `eagle_forward` against the JAX package's
(its `backend="xla"` path) on the same synthetic Q4_K packed, coded weights
carried across with `params_from_numpy`: f32 compute, f32 KV cache.

Tolerance: rtol 1e-4 (atol 1e-4 of the output's scale). The reference adds
the group bias into the dequantized weight; the port folds it as the qmm
kernel does (xsum_g @ bias), and the attention sums in another order."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.models.eagle import eagle_forward as jax_eagle_forward
from eagle_tpu.models.llama import llama_forward as jax_llama_forward
from eagle_tpu.models.synth import synth_eagle_params, synth_llama_params
from eagle_tpu.runtime.kvcache import KVCache as JaxKV
from eagle_tpu.runtime.kvcache import causal_mask_from_tags as jax_mask
from eagle_tpu_torch.convert import params_from_numpy
from eagle_tpu_torch.models.eagle import eagle_forward
from eagle_tpu_torch.models.llama import llama_forward
from eagle_tpu_torch.runtime.kvcache import KVCache, causal_mask_from_tags
from torch_port_util import (  # noqa: F401  (background_cpu: a fixture)
    background_cpu, tiny_cfgs, tree_to_numpy,
)

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files

MAX_SEQ = 128


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = tiny_cfgs()
    jt = synth_llama_params(jcfg, seed=0, on_device=True, packed=True, coded=True)
    jd = synth_eagle_params(dataclasses.replace(jcfg, n_layers=1, is_eagle=True), packed=True)
    tt = params_from_numpy(tree_to_numpy(jt), "cpu")
    td = params_from_numpy(tree_to_numpy(jd), "cpu")
    return jcfg, tcfg, jt, jd, tt, td


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def _jax_step(jt, jcfg, kv, tokens, positions, **kw):
    kv = kv.with_tags(positions, positions)
    mask = jax_mask(kv.slot_pos, positions)
    return jax_llama_forward(jt, jcfg, tokens, positions, kv, positions, mask,
                             backend="xla", compute_dtype=jnp.float32, **kw)


def _torch_step(tt, tcfg, kv, tokens, positions, **kw):
    kv.with_tags(positions, positions)
    mask = causal_mask_from_tags(kv.slot_pos, positions)
    return llama_forward(tt, tcfg, tokens, positions, kv, positions, mask,
                         compute_dtype=torch.float32, **kw)


@pytest.mark.parametrize("causal_tags_prefill", [False, True])
def test_llama_forward_prefill_then_decode(models, rng, causal_tags_prefill):
    """Prefill 12 tokens (through the prefill or the decode/verify attention
    path), then one decode step on the filled cache: logits, hidden and
    hidden_pre agree with the reference at each step."""
    jcfg, tcfg, jt, _, tt, _ = models
    toks = rng.integers(0, jcfg.vocab_size, size=(1, 13)).astype(np.int32)
    jkv = JaxKV.create(2, 1, MAX_SEQ, 2, 64, jnp.float32)
    tkv = KVCache.create(2, 1, MAX_SEQ, 2, 64, torch.float32, device="cpu")

    pos = np.arange(12, dtype=np.int32)[None]
    ref = _jax_step(jt, jcfg, jkv, jnp.asarray(toks[:, :12]), jnp.asarray(pos), kv_limit=128,
                    causal_tags_prefill=causal_tags_prefill)
    got = _torch_step(tt, tcfg, tkv, torch.from_numpy(toks[:, :12]), torch.from_numpy(pos),
                      kv_limit=128, causal_tags_prefill=causal_tags_prefill)
    for name in ("logits", "hidden", "hidden_pre"):
        _close(getattr(got, name), getattr(ref, name))
    np.testing.assert_allclose(got.kv.k.numpy(), np.asarray(ref.kv.k), rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(got.kv.slot_pos.numpy(), np.asarray(ref.kv.slot_pos))

    pos1 = np.array([[12]], np.int32)
    ref1 = _jax_step(jt, jcfg, ref.kv, jnp.asarray(toks[:, 12:]), jnp.asarray(pos1), kv_limit=128)
    got1 = _torch_step(tt, tcfg, got.kv, torch.from_numpy(toks[:, 12:]), torch.from_numpy(pos1),
                       kv_limit=128)
    for name in ("logits", "hidden", "hidden_pre"):
        _close(getattr(got1, name), getattr(ref1, name))


def test_eagle_forward_matches(models, rng):
    jcfg, tcfg, jt, jd, tt, td = models
    dj = dataclasses.replace(jcfg, n_layers=1, is_eagle=True)
    dt = dataclasses.replace(tcfg, n_layers=1, is_eagle=True)
    t = 5
    toks = rng.integers(0, jcfg.vocab_size, size=(1, t)).astype(np.int32)
    feats = rng.standard_normal((1, t, jcfg.n_embd)).astype(np.float32)
    pos = np.arange(t, dtype=np.int32)[None]
    jkv = JaxKV.create(1, 1, MAX_SEQ, 2, 64, jnp.float32).with_tags(jnp.asarray(pos), jnp.asarray(pos))
    ref = jax_eagle_forward(jd, jt, dj, jnp.asarray(toks), jnp.asarray(feats), jnp.asarray(pos),
                            jkv, jnp.asarray(pos), jax_mask(jkv.slot_pos, jnp.asarray(pos)),
                            backend="xla", compute_dtype=jnp.float32, kv_limit=128)
    tkv = KVCache.create(1, 1, MAX_SEQ, 2, 64, torch.float32, device="cpu")
    tpos = torch.from_numpy(pos)
    tkv.with_tags(tpos, tpos)
    got = eagle_forward(td, tt, dt, torch.from_numpy(toks), torch.from_numpy(feats), tpos,
                        tkv, tpos, causal_mask_from_tags(tkv.slot_pos, tpos),
                        compute_dtype=torch.float32, kv_limit=128)
    for name in ("logits", "feature", "feature_pre"):
        _close(getattr(got, name), getattr(ref, name))
    np.testing.assert_allclose(got.kv.v.numpy(), np.asarray(ref.kv.v), rtol=1e-4, atol=1e-5)


def test_unported_architecture_raises(models):
    jcfg, tcfg, _, _, tt, _ = models
    tkv = KVCache.create(2, 1, MAX_SEQ, 2, 64, torch.float32, device="cpu")
    pos = torch.zeros((1, 1), dtype=torch.int32)
    mask = causal_mask_from_tags(tkv.slot_pos, pos)
    bad = dict(tt, layers=dict(tt["layers"], ffn_gate_inp=tt["layers"]["ffn_norm"]))
    with pytest.raises(NotImplementedError):
        llama_forward(bad, tcfg, pos, pos, tkv, pos, mask, compute_dtype=torch.float32)
    with pytest.raises(NotImplementedError):
        llama_forward(tt, dataclasses.replace(tcfg, use_alibi=True), pos, pos, tkv, pos, mask)
    with pytest.raises(NotImplementedError):
        llama_forward(tt, dataclasses.replace(tcfg, rope_yarn_log_mul=0.1), pos, pos, tkv, pos,
                      mask)
