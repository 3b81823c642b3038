"""YaRN rope scaling in the port (eagle_tpu_torch/ops/rope.py:
`_yarn_corr_dims`, `yarn_blend`, `rope_mscale_cfg`, `rope_freqs_cfg`)
against the reference (eagle_tpu/ops/rope.py) and ggml's per-dim rope_yarn
loop, on the CPU:

- the blended frequencies and mscale reproduce ggml's rope_yarn loop
  (tests/test_rope_scaling.py's cases, on the port), and equal the
  reference's: the blend and its correction range bit for bit, the
  frequencies at rtol 1e-6; a linear config takes 1/factor;
- `llama_forward` on a YaRN config at positions up to three times the
  original context: logits at rtol 1e-4 against the reference's, and
  unlike the linear config's;
- the context shift and Self-Extend on a YaRN config (blended frequencies,
  no mscale): the next token's logits at rtol 1e-4 against the
  reference's, layer 0's shifted keys equal to a recompute at the moved
  positions, and
  `Generator.generate` with `context_shift_keep` / `grp_attn_n` giving the
  reference's tokens.

Weights: the tiny GGUF pair's target (`tiny_engine_pair`: the tiny_cfgs
shapes, Q8_0), loaded by both packages, with YaRN set in its config; f32
compute and cache."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eagle_tpu.models.llama import llama_forward as jax_llama_forward
from eagle_tpu.models.loader import load_llama_params as jax_load
from eagle_tpu.ops import rope as jrope
from eagle_tpu.runtime import kvcache as jkv
from eagle_tpu.runtime.generate import Generator as JaxGenerator
from eagle_tpu_torch.models.config import ModelConfig
from eagle_tpu_torch.models.llama import llama_forward
from eagle_tpu_torch.models.loader import load_llama_params
from eagle_tpu_torch.ops import rope
from eagle_tpu_torch.runtime.generate import Generator
from eagle_tpu_torch.runtime.kvcache import (
    KVCache,
    causal_mask_from_tags,
    context_shift,
    self_extend_shift,
)
from test_rope_scaling import _ggml_rope_yarn_oracle
from torch_port_util import (  # noqa: F401  (background_cpu: a fixture)
    ENGINE_PROMPT, background_cpu, tiny_engine_pair,
)

pytestmark = pytest.mark.usefixtures("background_cpu")  # yields the CPU to other files

MAX_SEQ = 128
ORIG = 32  # the original context: positions past it take the blend's interpolated part
YARN = dict(rope_scaling="yarn", rope_scale_factor=4.0, rope_orig_ctx=ORIG)


def _cfg(factor, orig_ctx, attn_factor, **kw):
    head_dim = 64
    return ModelConfig(arch="llama", vocab_size=1, n_embd=head_dim, n_layers=1, n_heads=1,
                       n_kv_heads=1, head_dim=head_dim, n_ff=1, rope_dim=head_dim,
                       rope_base=10000.0, rope_scaling="yarn", rope_scale_factor=factor,
                       rope_orig_ctx=orig_ctx, rope_attn_factor=attn_factor, **kw)


@pytest.mark.parametrize("factor,orig_ctx,attn_factor", [
    (4.0, 64, 1.0),
    (8.0, 128, 1.3),
    (2.0, 32, 1.0),
])
def test_yarn_freqs_match_ggml_rope_yarn(factor, orig_ctx, attn_factor):
    """The port's blended inv_freq and mscale reproduce ggml's per-dim
    rope_yarn loop (the reference's case at :123, on the port); a linear
    config takes 1/factor and the bare attn_factor."""
    head_dim, base = 64, 10000.0
    cfg = _cfg(factor, orig_ctx, attn_factor)
    inv_freq, mscale = rope.rope_freqs_cfg(cfg, device="cpu")
    pos = np.array([0, 1, 17, orig_ctx - 1, orig_ctx * 2, orig_ctx * 4 - 3])
    angles = pos[:, None] * inv_freq.double().numpy()[None, :]
    ref_cos, ref_sin = _ggml_rope_yarn_oracle(
        pos, head_dim, base, 1.0 / factor, orig_ctx, 1.0, attn_factor, 32.0, 1.0)
    np.testing.assert_allclose(np.cos(angles) * mscale, ref_cos, atol=1e-4)
    np.testing.assert_allclose(np.sin(angles) * mscale, ref_sin, atol=1e-4)

    inv_lin, ms_lin = rope.rope_freqs_cfg(dataclasses.replace(cfg, rope_scaling="linear"),
                                          device="cpu")
    base_freqs = 1.0 / (base ** (np.arange(0, head_dim, 2) / head_dim))
    np.testing.assert_allclose(inv_lin.numpy(), base_freqs / factor, rtol=1e-6)
    assert ms_lin == attn_factor


CONFIGS = [dict(factor=4.0, orig_ctx=64, attn_factor=1.0),
           dict(factor=16.0, orig_ctx=4096, attn_factor=1.0),  # Yarn-Llama-2-7b-64k
           dict(factor=8.0, orig_ctx=128, attn_factor=1.3, rope_beta_fast=16.0,
                rope_beta_slow=2.0),
           dict(factor=4.0, orig_ctx=64, attn_factor=1.0, rope_ext_factor=0.5),
           dict(factor=4.0, orig_ctx=0, attn_factor=1.0, n_ctx_train=256),  # orig from training
           dict(factor=4.0, orig_ctx=64, attn_factor=1.0, rope_yarn_log_mul=0.1)]


@pytest.mark.parametrize("kw", CONFIGS, ids=[str(i) for i in range(len(CONFIGS))])
def test_yarn_matches_reference(kw):
    """Blend, correction range and mscale equal the reference's; the
    frequencies at rtol 1e-6 (the two pow's last bit)."""
    from eagle_tpu.models.config import ModelConfig as JaxCfg

    cfg = _cfg(**kw)
    jcfg = JaxCfg(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
                     if hasattr(JaxCfg, f.name)})
    ext, orig = rope._yarn_active(cfg)
    assert (ext, orig) == jrope._yarn_active(jcfg)
    args = (cfg.rope_dim, orig, cfg.rope_base, cfg.rope_beta_fast, cfg.rope_beta_slow)
    assert rope._yarn_corr_dims(*args) == jrope._yarn_corr_dims(*args)
    blend_args = (cfg.rope_dim, orig, cfg.rope_base, cfg.rope_scale_factor, ext,
                  cfg.rope_beta_fast, cfg.rope_beta_slow)
    got, want = rope.yarn_blend(*blend_args), jrope.yarn_blend(*blend_args)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    inv_freq, mscale = rope.rope_freqs_cfg(cfg, device="cpu")
    j_inv, j_mscale = jrope.rope_freqs_cfg(jcfg)
    np.testing.assert_allclose(inv_freq.numpy(), np.asarray(j_inv), rtol=1e-6)
    assert mscale == j_mscale == rope.rope_mscale_cfg(cfg)


# ---- the forward, the shift and Self-Extend on a YaRN model ----------------


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = tiny_engine_pair(tmp_path_factory.mktemp("yarn"), ENGINE_PROMPT)[0]
    tt, tcfg, _ = load_llama_params(path, device="cpu")
    jt, jcfg, _ = jax_load(path)
    jcfg, tcfg = (dataclasses.replace(c, **YARN) for c in (jcfg, tcfg))
    return dict(jcfg=jcfg, tcfg=tcfg, jt=jt, tt=tt)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def _jax_forward(m, kv, tokens, positions):
    positions = jnp.asarray(positions)
    kv = kv.with_tags(positions, positions)
    mask = jkv.causal_mask_from_tags(kv.slot_pos, positions)
    return jax_llama_forward(m["jt"], m["jcfg"], jnp.asarray(tokens), positions, kv, positions,
                             mask, backend="xla", compute_dtype=jnp.float32)


def _forward(m, kv, tokens, positions, cfg=None):
    positions = torch.from_numpy(np.asarray(positions, np.int32))
    kv.with_tags(positions, positions)
    mask = causal_mask_from_tags(kv.slot_pos, positions)
    return llama_forward(m["tt"], cfg or m["tcfg"], torch.from_numpy(tokens), positions, kv,
                         positions, mask, compute_dtype=torch.float32)


def _caches(m):
    return (jkv.KVCache.create(2, 1, MAX_SEQ, 2, 64, jnp.float32),
            KVCache.create(2, 1, MAX_SEQ, 2, 64, torch.float32, device="cpu"))


def test_yarn_forward_past_original_context(models, rng):
    """A prompt of 3 x the original context: logits at rtol 1e-4 against
    the reference's; the linear config's logits differ (the blend acts)."""
    m = models
    toks = rng.integers(0, 512, size=(1, 3 * ORIG)).astype(np.int32)
    pos = np.arange(3 * ORIG, dtype=np.int32)[None]
    jcache, cache = _caches(m)
    want = _jax_forward(m, jcache, toks, pos)
    got = _forward(m, cache, toks, pos)
    _close(got.logits, want.logits)
    lin = _forward(m, _caches(m)[1], toks, pos,
                   cfg=dataclasses.replace(m["tcfg"], rope_scaling="linear"))
    assert (lin.logits - got.logits).abs().max() > 1e-3


SHIFTS = {"context_shift": (6, 30), "self_extend": (2, 32)}  # (keep, discard) / (ga_n, ga_w)


@pytest.mark.parametrize("kind", list(SHIFTS))
def test_yarn_shift_matches_reference(models, rng, kind):
    """Prefill 80 tokens, shift the cache (the context shift or one
    Self-Extend step, blended frequencies without mscale), then feed one
    token: its logits at rtol 1e-4 against the reference's after the same
    shift. A context shift also equals a recompute: layer 0's keys (a
    function of the token and its position only) equal those of the kept
    tokens fed afresh at their new positions, mscale once."""
    m = models
    n = 80
    toks = rng.integers(0, 512, size=(1, n + 1)).astype(np.int32)
    pos = np.arange(n, dtype=np.int32)[None]
    jcache, cache = _caches(m)
    jcache = _jax_forward(m, jcache, toks[:, :n], pos).kv
    _forward(m, cache, toks[:, :n], pos)
    j_inv = jrope.rope_freqs_cfg(m["jcfg"])[0]
    inv = rope.rope_freqs_cfg(m["tcfg"], device="cpu")[0]
    a, b = SHIFTS[kind]
    if kind == "context_shift":
        jcache = jkv.context_shift(jcache, j_inv, a, b)
        context_shift(cache, inv, a, b)
        nxt = n - b
    else:
        jcache, nxt, _ = jkv.self_extend_shift(jcache, j_inv, n, 0, a, b)
        got_n, _ = self_extend_shift(cache, inv, n, 0, a, b)
        assert got_n == nxt
    np.testing.assert_array_equal(cache.slot_pos.numpy(), np.asarray(jcache.slot_pos))
    np.testing.assert_allclose(cache.k.numpy(), np.asarray(jcache.k), rtol=1e-4, atol=1e-5)
    # the next token goes to slot n (the context shift freed slots: the next free one)
    slot = nxt if kind == "context_shift" else n
    p = np.array([[nxt]], np.int32)
    jcache = jcache.with_tags(jnp.asarray([[slot]]), jnp.asarray(p))
    want = jax_llama_forward(m["jt"], m["jcfg"], jnp.asarray(toks[:, n:]), jnp.asarray(p),
                             jcache, jnp.asarray([[slot]]),
                             jkv.causal_mask_from_tags(jcache.slot_pos, jnp.asarray(p)),
                             backend="xla", compute_dtype=jnp.float32)
    sl = torch.tensor([[slot]], dtype=torch.int32)
    cache.with_tags(sl, torch.from_numpy(p))
    got = llama_forward(m["tt"], m["tcfg"], torch.from_numpy(toks[:, n:]), torch.from_numpy(p),
                        cache, sl, causal_mask_from_tags(cache.slot_pos, torch.from_numpy(p)),
                        compute_dtype=torch.float32)
    _close(got.logits, want.logits)
    if kind == "context_shift":  # layer 0's keys depend on the token and position only
        kept = np.concatenate([toks[:, :a], toks[:, a + b:n]], axis=1)
        fresh = _caches(m)[1]
        _forward(m, fresh, kept, np.arange(nxt, dtype=np.int32)[None])
        np.testing.assert_allclose(cache.k[0, :, :, :nxt].numpy(), fresh.k[0, :, :, :nxt].numpy(),
                                   rtol=1e-5, atol=1e-5)


GENERATE = {"context_shift_keep": dict(context_shift_keep=4),
            "grp_attn_n": dict(grp_attn_n=2, grp_attn_w=32)}


@pytest.mark.parametrize("kind", list(GENERATE))
def test_yarn_generate_shifts_like_reference(models, kind):
    """`Generator.generate` past max_seq with `context_shift_keep`, and with
    Self-Extend, on the YaRN model: the reference's tokens."""
    m = models
    prompt = np.random.default_rng(5).integers(3, 512, size=20).tolist()
    kw = dict(max_new_tokens=150 if kind == "context_shift_keep" else 60, stop_at_eos=False,
              **GENERATE[kind])
    jgen = JaxGenerator(m["jt"], m["jcfg"], max_seq=MAX_SEQ, batch=1, backend="xla",
                        compute_dtype=jnp.float32, kv_dtype=jnp.float32, eos_id=-1)
    want = jgen.generate(prompt, **kw)
    gen = Generator(m["tt"], m["tcfg"], max_seq=MAX_SEQ, kv_dtype=torch.float32,
                    compute_dtype=torch.float32, eos_id=-1, device="cpu")
    assert gen.generate(prompt, **kw) == list(want)
    assert len(want) == kw["max_new_tokens"]


def test_yarn_llama_hf_parity(tmp_path, rng):
    """The reference's HF case (:156) on the port: an HF Llama with YaRN
    rope scaling, converted to a Q8_0 GGUF by the reference's converter
    (the scaling keys written), loaded by the port: logits past the
    original context at rtol 1e-4 against the reference's forward on the
    same file, and closer to HF's than the linear config's."""
    transformers = pytest.importorskip("transformers")
    from eagle_tpu.gguf.constants import GGMLType
    from eagle_tpu.models.hf_convert import config_from_hf, convert_hf_to_gguf
    from eagle_tpu.models.loader import load_llama_params as jax_load
    from eagle_tpu_torch.models.loader import load_llama_params

    torch.manual_seed(212)
    orig = 32
    hf_cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=256, attn_implementation="eager", tie_word_embeddings=False,
        rope_scaling={"rope_type": "yarn", "factor": 4.0, "original_max_position_embeddings": orig},
    )
    model = transformers.LlamaForCausalLM(hf_cfg).eval()
    path = tmp_path / "yarn.gguf"
    convert_hf_to_gguf(model.state_dict(), config_from_hf(hf_cfg), path, qtype=GGMLType.Q8_0)
    params, cfg, _ = load_llama_params(path, device="cpu")
    assert (cfg.rope_scaling, cfg.rope_orig_ctx) == ("yarn", orig)
    jparams, jcfg, _ = jax_load(path)
    tokens = rng.integers(0, 128, size=(1, 3 * orig)).astype(np.int32)
    pos = np.arange(3 * orig, dtype=np.int32)[None]
    m = dict(jt=jparams, jcfg=jcfg, tt=params, tcfg=cfg)
    jcache = jkv.KVCache.create(2, 1, MAX_SEQ, 2, 16, jnp.float32)
    want = _jax_forward(m, jcache, tokens, pos).logits
    ours = _forward(m, KVCache.create(2, 1, MAX_SEQ, 2, 16, torch.float32, device="cpu"),
                    tokens, pos).logits
    _close(ours, want)
    lin = _forward(m, KVCache.create(2, 1, MAX_SEQ, 2, 16, torch.float32, device="cpu"),
                   tokens, pos, cfg=dataclasses.replace(cfg, rope_scaling="linear")).logits
    with torch.no_grad():
        hf = model(torch.tensor(tokens, dtype=torch.long)).logits
    assert (ours - hf).abs().max() < (lin - hf).abs().max()


def test_yarn_gguf_config_reads_the_scaling_keys():
    """A Yarn-Llama-2-7b-64k style GGUF's keys give the YaRN config (and
    the attention-scale multiplier of deepseek2's MLA is still refused,
    naming its ROADMAP item)."""
    md = {"general.architecture": "llama", "llama.embedding_length": 256,
          "llama.attention.head_count": 4, "llama.block_count": 2,
          "llama.feed_forward_length": 512, "llama.context_length": 65536,
          "llama.vocab_size": 512, "llama.rope.scaling.type": "yarn",
          "llama.rope.scaling.factor": 16.0,
          "llama.rope.scaling.original_context_length": 4096}
    cfg = ModelConfig.from_gguf_metadata(md)
    assert (cfg.rope_scaling, cfg.rope_scale_factor, cfg.rope_orig_ctx) == ("yarn", 16.0, 4096)
    assert rope.rope_mscale_cfg(cfg) == pytest.approx(1.0 + 0.1 * np.log(16.0))
    with pytest.raises(NotImplementedError, match="item 8"):
        ModelConfig.from_gguf_metadata({**md, "llama.rope.scaling.yarn_log_multiplier": 0.1})
