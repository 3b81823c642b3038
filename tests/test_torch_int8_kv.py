"""The port's int8 KV caches and Self-Extend (eagle_tpu_torch/runtime/kvcache.py,
the int8 branches of models/llama.py, runtime/generate.py's `grp_attn_n`)
against the reference's on the CPU:

- `quantize_kv_vec` / `dequantize_kv` bit-equal to the reference's on seeded
  f32 and bf16 vectors that include all-zero vectors and exact .5 ties;
- int8 `Generator` and chain-engine tokens identical to the reference's int8
  engines (f32 compute, as tests/test_int8_kv.py), the scales the prompt
  leaves in the cache at rtol 1e-5 and its codes within one step (the two
  forwards' f32 keys differ in their last bits);
- the int8 context shift against the reference's at rtol 1e-5;
- `self_extend_shift` (tags exact, keys at rtol 1e-5, float and int8) and
  `generate(grp_attn_n=2 and 4)` against the reference: identical tokens
  (tests/test_self_extend.py's setups)."""

import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from eagle_tpu.models.synth import synth_eagle_params, synth_llama_params
from eagle_tpu.ops.rope import rope_freqs as jax_rope_freqs
from eagle_tpu.runtime import kvcache as jkv
from eagle_tpu.runtime.generate import Generator as JaxGenerator
from eagle_tpu.runtime.speculative import EagleChainEngine as JaxEngine
from eagle_tpu_torch.convert import params_from_numpy
from eagle_tpu_torch.ops.rope import rope_freqs
from eagle_tpu_torch.runtime import kvcache
from eagle_tpu_torch.runtime.generate import Generator
from eagle_tpu_torch.runtime.speculative import EagleChainEngine
from torch_port_util import (  # noqa: F401  (background_cpu: a fixture)
    assert_bits_equal, background_cpu, tiny_cfgs, tree_to_numpy,
)

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files

MAX_SEQ = 128
N_NEW = 20


def _vectors(dtype) -> np.ndarray:
    """[3, 4, 7, 64] seeded vectors: normal rows, two all-zero rows, and
    rows whose absmax is 127 times a power of two with entries at exact
    half-integer multiples of the scale (round-half-to-even ties)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 4, 7, 64)).astype(np.float32) * 3
    x[0, 1, 2] = 0.0
    x[2, 3, 6] = 0.0
    for i, s in enumerate((1.0, 0.25, 4.0)):
        ties = (rng.integers(-126, 126, 64) + 0.5) * s
        ties[0] = 127 * s
        x[i, 0, 0] = ties
        x[i, 2, 5] = -ties
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_bit_equal_to_reference(dtype):
    np_dtype = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    x = _vectors(np_dtype)
    codes, scale = kvcache.quantize_kv_vec(torch.from_numpy(x.astype(np.float32)).to(
        getattr(torch, dtype)))
    want_codes, want_scale = jkv.quantize_kv_vec(jnp.asarray(x))
    assert_bits_equal(codes, want_codes, "codes")
    assert_bits_equal(scale, want_scale, "scale")
    assert (np.asarray(want_codes)[0, 0, 0, 1:] % 2 == 0).all()  # the ties went to even
    assert not codes[0, 1, 2].any() and scale[0, 1, 2] == 0
    for out in (torch.bfloat16, torch.float32):
        got = kvcache.dequantize_kv(codes, scale, out)
        want = jkv.dequantize_kv(want_codes, want_scale, jnp.bfloat16 if out == torch.bfloat16
                                 else jnp.float32)
        assert_bits_equal(got, np.asarray(want), f"dequantized to {out}")


def test_int8_cache_layout():
    kv = kvcache.KVCache.create(2, 3, 16, 4, 8, dtype=torch.int8, device="cpu", spill=2)
    assert kv.quantized and kv.k.dtype == torch.int8
    assert kv.k_scale.shape == (2, 3, 4, 18) and kv.k_scale.dtype == torch.float32
    row = kv.row(1)
    row.k_scale.fill_(2.0)
    assert (kv.k_scale[:, 1] == 2.0).all() and (kv.k_scale[:, 0] == 0).all()
    assert len(kv.tensors()) == 5


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = tiny_cfgs()
    jt = synth_llama_params(jcfg, seed=0, on_device=True, packed=True, coded=True)
    jd = synth_eagle_params(dataclasses.replace(jcfg, n_layers=1, is_eagle=True), packed=True)
    tt = params_from_numpy(tree_to_numpy(jt), "cpu")
    td = params_from_numpy(tree_to_numpy(jd), "cpu")
    prompt = np.random.default_rng(5).integers(0, jcfg.vocab_size, size=11).tolist()
    return dict(jcfg=jcfg, tcfg=tcfg, jt=jt, jd=jd, tt=tt, td=td, prompt=prompt)


def test_int8_generator_matches_reference(setup):
    s = setup
    ref = JaxGenerator(s["jt"], s["jcfg"], max_seq=MAX_SEQ, kv_dtype=jnp.int8,
                       compute_dtype=jnp.float32, backend="xla", eos_id=-1)
    want = ref.generate(s["prompt"], max_new_tokens=N_NEW, stop_at_eos=False, chunk=8)
    gen = Generator(s["tt"], s["tcfg"], max_seq=MAX_SEQ, kv_dtype=torch.int8,
                    compute_dtype=torch.float32, eos_id=-1, device="cpu")
    got = gen.generate(s["prompt"], max_new_tokens=N_NEW, stop_at_eos=False, chunk=8)
    assert got == want
    # the prompt's rows: the two forwards' f32 K/V agree to rounding, so the
    # scales to rtol 1e-5 and the codes to one step
    n = len(s["prompt"])
    for c in ("k", "v"):
        sc = getattr(gen.kv, f"{c}_scale")[:, :, :, :n].numpy()
        want_sc = np.asarray(getattr(ref.kv, f"{c}_scale"))[:, :, :, :n]
        np.testing.assert_allclose(sc, want_sc, rtol=1e-5)
        codes = getattr(gen.kv, c)[:, :, :, :n].numpy().astype(np.int32)
        want_codes = np.asarray(getattr(ref.kv, c))[:, :, :, :n].astype(np.int32)
        assert np.abs(codes - want_codes).max() <= 1
        assert (codes != want_codes).mean() < 1e-3


def test_int8_chain_matches_reference(setup):
    s = setup
    ref = JaxEngine(s["jt"], s["jd"], s["jcfg"], n_draft=3, max_seq=MAX_SEQ,
                    kv_dtype=jnp.int8, compute_dtype=jnp.float32, backend="xla", eos_id=-1)
    want, want_stats = ref.generate(s["prompt"], max_new_tokens=N_NEW, stop_at_eos=False)
    eng = EagleChainEngine(s["tt"], s["td"], s["tcfg"], n_draft=3, max_seq=MAX_SEQ,
                           kv_dtype=torch.int8, compute_dtype=torch.float32, eos_id=-1,
                           device="cpu")
    got, stats = eng.generate(s["prompt"], max_new_tokens=N_NEW, stop_at_eos=False)
    assert got == want
    assert (stats["n_cycles"], stats["n_accepted"]) == (want_stats["n_cycles"],
                                                        want_stats["n_accepted"])


def _int8_pair(seed: int, s: int = 32, tagged: int = 24):
    """The same int8 cache on both sides: seeded codes and scales, tags
    0..tagged-1 (L 2, B 1, H 2, D 64)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, (2, 1, 2, s, 64)).astype(np.int8)
    scales = rng.uniform(0.001, 0.05, (2, 1, 2, s)).astype(np.float32)
    tags = np.where(np.arange(s) < tagged, np.arange(s), -1).astype(np.int32)[None]
    ref = jkv.KVCache(k=jnp.asarray(codes), v=jnp.asarray(codes[::-1].copy()),
                      slot_pos=jnp.asarray(tags), k_scale=jnp.asarray(scales),
                      v_scale=jnp.asarray(scales[::-1].copy()))
    port = kvcache.KVCache.create(2, 1, s, 2, 64, dtype=torch.int8, device="cpu")
    for name in ("k", "v", "k_scale", "v_scale", "slot_pos"):
        getattr(port, name).copy_(torch.from_numpy(np.array(getattr(ref, name))))
    return ref, port


def _dequant(kv):
    return np.asarray(kv.k, np.float32) * np.asarray(kv.k_scale)[..., None]


def test_int8_context_shift_matches_reference():
    ref, port = _int8_pair(1)
    ptrs = [t.data_ptr() for t in port.tensors()]
    want = jkv.context_shift(ref, jax_rope_freqs(64, 10000.0), n_keep=4, n_discard=6)
    kvcache.context_shift(port, rope_freqs(64, 10000.0, device="cpu"), n_keep=4, n_discard=6)
    assert [t.data_ptr() for t in port.tensors()] == ptrs  # in place
    np.testing.assert_array_equal(port.slot_pos.numpy(), np.asarray(want.slot_pos))
    got_k = port.k.float().numpy() * port.k_scale.numpy()[..., None]
    np.testing.assert_allclose(got_k, _dequant(want), rtol=1e-5, atol=1e-7)
    for name in ("v", "v_scale"):  # V moves as it is
        assert_bits_equal(getattr(port, name), np.asarray(getattr(want, name)), name)


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("ga_n,ga_w", [(2, 4), (4, 8), (2, 8)])
def test_self_extend_shift_matches_reference(ga_n, ga_w, quantized):
    """Every compression step of the shift loop, as main.cpp iterates it
    (tests/test_self_extend.py): tags exact, n_past and ga_i equal, keys at
    rtol 1e-5."""
    if quantized:
        ref, port = _int8_pair(2, s=32, tagged=16)
    else:
        rng = np.random.default_rng(3)
        k = rng.standard_normal((2, 1, 2, 32, 64)).astype(np.float32)
        tags = np.where(np.arange(32) < 16, np.arange(32), -1).astype(np.int32)[None]
        ref = jkv.KVCache(k=jnp.asarray(k), v=jnp.asarray(k), slot_pos=jnp.asarray(tags))
        port = kvcache.KVCache.create(2, 1, 32, 2, 64, dtype=torch.float32, device="cpu")
        port.k.copy_(torch.from_numpy(k))
        port.slot_pos.copy_(torch.from_numpy(tags))
    jf, tf = jax_rope_freqs(64, 10000.0), rope_freqs(64, 10000.0, device="cpu")
    n_past, ga_i, steps = 16, 0, 0
    while n_past >= ga_i + ga_w:
        ref, n_want, ga_want = jkv.self_extend_shift(ref, jf, n_past, ga_i, ga_n, ga_w)
        n_past, ga_i = kvcache.self_extend_shift(port, tf, n_past, ga_i, ga_n, ga_w)
        assert (n_past, ga_i) == (n_want, ga_want)
        np.testing.assert_array_equal(port.slot_pos.numpy(), np.asarray(ref.slot_pos))
        got = (port.k.float().numpy() * port.k_scale.numpy()[..., None] if quantized
               else port.k.numpy())
        np.testing.assert_allclose(got, _dequant(ref) if quantized else np.asarray(ref.k),
                                   rtol=1e-5, atol=1e-6)
        steps += 1
    assert steps >= 1


@pytest.mark.parametrize("kv_dtype", ["float32", "int8"])
@pytest.mark.parametrize("ga_n,ga_w", [(2, 16), (4, 32)])
def test_generate_self_extend_matches_reference(setup, ga_n, ga_w, kv_dtype):
    """`generate(grp_attn_n=...)` gives the reference's tokens, and the
    positions stay compressed below the token count."""
    s = setup
    prompt = list(range(10))
    ref = JaxGenerator(s["jt"], s["jcfg"], max_seq=MAX_SEQ, kv_dtype=getattr(jnp, kv_dtype),
                       compute_dtype=jnp.float32, backend="xla", eos_id=-1)
    want = ref.generate(prompt, max_new_tokens=40, stop_at_eos=False, grp_attn_n=ga_n,
                        grp_attn_w=ga_w)
    gen = Generator(s["tt"], s["tcfg"], max_seq=MAX_SEQ, kv_dtype=getattr(torch, kv_dtype),
                    compute_dtype=torch.float32, eos_id=-1, device="cpu")
    got = gen.generate(prompt, max_new_tokens=40, stop_at_eos=False, grp_attn_n=ga_n,
                       grp_attn_w=ga_w)
    assert got == want and len(got) == 40
    np.testing.assert_array_equal(gen.kv.slot_pos[:, :MAX_SEQ].numpy(),
                                  np.asarray(ref.kv.slot_pos))
    assert int(gen.kv.slot_pos.max()) < 10 + 40 - 1
