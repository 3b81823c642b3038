"""Synthetic models: random weights in the real serving layouts and shapes
(port of eagle_tpu/models/synth.py: `VICUNA_7B`, `synth_qtensor`,
`synth_llama_params`, `synth_eagle_params`), with the optional tensors of
the Qwen2, Qwen3 and Gemma-2 branches (`bqkv`, per-head q/k norms, sandwich
norms), of the position families (learned positions `pos_embd`, the
embedding LayerNorm `tok_embd_norm(_b)`, a no-gate `w_up`, a tied head)
and of the other LayerNorm families (no norm tensor at all under
`cfg.nonparam_norms`, one shared input norm, an lm_head bias).

Weights are generated on the device with a seeded `torch.Generator` — no
host upload — in the fused (`wqkv`, `w_gate_up`), layer-stacked "kn" layout
of the reference's on-device synthesis. Values differ from the JAX
package's (different generators); the tests carry the reference's weights
across instead (convert.py)."""

from __future__ import annotations

from typing import Any

import torch

from .._device import resolve_device
from ..gguf.constants import GGMLType
from ..quant.qtensor import Q4_K, Q6_K, QTensor
from .config import ModelConfig

VICUNA_7B = ModelConfig(
    arch="llama", vocab_size=32000, n_embd=4096, n_layers=32, n_heads=32,
    n_kv_heads=32, head_dim=128, n_ff=11008, rms_eps=1e-6, rope_base=10000.0,
    rope_dim=128, n_ctx_train=2048,
)

#: ggml type -> (group, q range [lo, hi), has bias)
_FORMATS = {Q4_K: (32, 0, 16, True), Q6_K: (16, -32, 32, False),
            int(GGMLType.Q4_0): (32, 0, 16, True), int(GGMLType.Q8_0): (32, -128, 128, False)}


def _uniform(gen, shape, lo, hi, device):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def synth_qtensor(
    gen: torch.Generator,
    n: int,
    k: int,
    qtype: int = Q4_K,
    stack: int | None = None,
    packed: bool = False,
    scale_dtype=torch.float32,
    coded: bool = False,
) -> QTensor:
    """Random "kn" QTensor of logical shape [N, K] (optionally layer-stacked)
    on `gen`'s device. Packed Q4 codes are drawn directly as random bytes
    (two random nibbles each), never materialized unpacked."""
    if qtype not in _FORMATS:
        raise NotImplementedError(f"synthetic ggml type {qtype} not ported yet")
    group, lo, hi, has_bias = _FORMATS[qtype]
    dev = gen.device
    lead = () if stack is None else (stack,)
    sshape = lead + (k // group, n)
    scale_mag = 0.02 / max(1, hi - 1)
    if packed:
        if lo < 0 or hi > 16:
            raise ValueError("only 4-bit codes pack")
        q = torch.randint(-128, 128, lead + (k // 2, n), generator=gen, device=dev,
                          dtype=torch.int8)
    else:
        q = torch.randint(lo, hi, lead + (k, n), generator=gen, device=dev, dtype=torch.int8)
    sup = sup_min = None
    if coded:
        # k-quant super-block factorization: int8 sub-scale codes + f32
        # per-256 super-scales (bias: min codes + NEGATED super-mins)
        if k % 256:
            raise ValueError("coded scales need K % 256 == 0")
        sshape2 = lead + (k // 256, n)
        code_mag = scale_mag / 32.0
        scale = torch.randint(1, 64, sshape, generator=gen, device=dev, dtype=torch.int8)
        sup = _uniform(gen, sshape2, 0.5, 1.5, dev) * code_mag
        bias = None
        if has_bias:
            bias = torch.randint(0, 64, sshape, generator=gen, device=dev, dtype=torch.int8)
            sup_min = -_uniform(gen, sshape2, 0.5, 1.5, dev) * code_mag
    else:
        scale = (_uniform(gen, sshape, 0.5, 1.5, dev) * scale_mag).to(scale_dtype)
        bias = None
        if has_bias:
            bias = (torch.randn(sshape, generator=gen, device=dev) * scale_mag).to(scale_dtype)
    return QTensor(q=q, scale=scale, bias=bias, group=group, ggml_type=qtype,
                   layout="kn", packed=packed, sup=sup, sup_min=sup_min)


def synth_llama_params(
    cfg: ModelConfig,
    qtype: int = Q4_K,
    seed: int = 0,
    embed_dtype=torch.bfloat16,
    packed: bool = False,
    scale_dtype=torch.float32,
    coded: bool = False,
    device="cuda",
    qk_norm: bool = False,
    gate: bool = True,
    embd_norm: bool = False,
    tied: bool = False,
    ffn_norm: bool = True,
    out_bias: bool = False,
) -> dict[str, Any]:
    """Target params: fused qkv and gate+up along N, layer-stacked. With
    `cfg.attn_bias` also `bqkv` (qwen2; the bias of a pre-fused `attn_qkv`),
    with `qk_norm` per-head q/k norms (qwen3), with `cfg.post_norms` the
    sandwich norms (gemma2). Without `gate` the FFN is the no-gate MLP's
    `w_up` (gpt2, starcoder, bloom, mpt); `cfg.has_pos_embd` adds learned
    positions `pos_embd` [n_ctx_train, D] f32 (gpt2, starcoder), `embd_norm`
    the embedding LayerNorm's weight and bias (bloom), and `tied` makes the
    embedding table the head (gpt2, bloom, mpt). `cfg.nonparam_norms` leaves
    out every norm tensor (olmo), `ffn_norm=False` the FFN's own norm (the
    parallel block's one shared input norm: falcon, gptj), and `out_bias`
    adds the lm_head bias `output_b` (gptj)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    L, d, dh, h, hkv, f, v = (
        cfg.n_layers, cfg.n_embd, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads,
        cfg.n_ff, cfg.vocab_size,
    )
    qa = dict(qtype=qtype, packed=packed, scale_dtype=scale_dtype, coded=coded)
    layers = {
        "attn_norm": torch.ones((L, d), device=dev),
        "wqkv": synth_qtensor(gen, (h + 2 * hkv) * dh, d, stack=L, **qa),
        "wo": synth_qtensor(gen, d, h * dh, stack=L, **qa),
        "ffn_norm": torch.ones((L, d), device=dev),
        "w_gate_up" if gate else "w_up": synth_qtensor(gen, (2 if gate else 1) * f, d, stack=L,
                                                        **qa),
        "w_down": synth_qtensor(gen, d, f, stack=L, **qa),
    }
    emb = (torch.randn((v, d), generator=gen, device=dev) * 0.02).to(embed_dtype)
    if cfg.attn_bias:
        layers["bqkv"] = torch.randn((L, (h + 2 * hkv) * dh), generator=gen, device=dev) * 0.02
    if qk_norm:
        layers["attn_q_norm"] = torch.ones((L, dh), device=dev)
        layers["attn_k_norm"] = torch.ones((L, dh), device=dev)
    if cfg.post_norms:
        layers["post_attn_norm"] = torch.ones((L, d), device=dev)
        layers["post_ffn_norm"] = torch.ones((L, d), device=dev)
    if not ffn_norm or cfg.nonparam_norms:
        del layers["ffn_norm"]
    if cfg.nonparam_norms:
        del layers["attn_norm"]
    params = {
        "tok_embd": emb,
        "layers": layers,
        "output": emb if tied else synth_qtensor(gen, v, d, **qa),
    }
    if not cfg.nonparam_norms:
        params["output_norm"] = torch.ones((d,), device=dev)
    if out_bias:
        params["output_b"] = torch.randn((v,), generator=gen, device=dev) * 0.02
    if cfg.has_pos_embd:
        params["pos_embd"] = torch.randn((cfg.n_ctx_train, d), generator=gen, device=dev) * 0.02
    if embd_norm:
        params["tok_embd_norm"] = torch.ones((d,), device=dev)
        params["tok_embd_norm_b"] = torch.zeros((d,), device=dev)
    return params


def synth_eagle_params(
    cfg: ModelConfig,
    qtype: int = Q4_K,
    seed: int = 1,
    embed_dtype=torch.bfloat16,
    packed: bool = False,
    scale_dtype=torch.float32,
    device="cuda",
) -> dict[str, Any]:
    """Draft-head params: one layer (single-layer stack, no attn_norm), the
    fc over [embed; feature] and its (zero) bias. `packed`/`scale_dtype`
    should match the target's."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    d, dh, h, hkv, f, v = (
        cfg.n_embd, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads, cfg.n_ff, cfg.vocab_size
    )
    qa = dict(qtype=qtype, packed=packed, scale_dtype=scale_dtype)
    layers = {
        "wqkv": synth_qtensor(gen, (h + 2 * hkv) * dh, d, stack=1, **qa),
        "wo": synth_qtensor(gen, d, h * dh, stack=1, **qa),
        "ffn_norm": torch.ones((1, d), device=dev),
        "w_gate_up": synth_qtensor(gen, 2 * f, d, stack=1, **qa),
        "w_down": synth_qtensor(gen, d, f, stack=1, **qa),
    }
    return {
        "tok_embd": (torch.randn((v, d), generator=gen, device=dev) * 0.02).to(embed_dtype),
        "fc_w": synth_qtensor(gen, d, 2 * d, **qa),
        "fc_b": torch.zeros((d,), device=dev),
        "layers": layers,
    }
