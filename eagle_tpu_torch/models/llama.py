"""Llama-family forward pass (port of eagle_tpu/models/llama.py:
`ForwardOutput`, `embed_lookup`, `_block_norm`, `_moe_ffn`, `_ffn`, `_layer_step`,
`llama_forward`, with the int8 and paged cache branches, Llama-3.1's rope
factors, a tied ("nk") head, and the config-driven branches of the Qwen2,
Qwen3, Gemma, Gemma-2, LayerNorm and position families).

RMSNorm, rotary GQA attention over the position-tagged cache, a gated FFN
(SiLU, or GELU for the Gemma families), with fused `wqkv` and `w_gate_up` weights kept
layer-stacked and read in place by the qmm kernel. One function serves
prefill, decode and speculative verify. The branches, each read from the
config or from the weights present, as the reference reads them:
- `bqkv`: q/k/v biases added after the `wqkv` product (qwen2, starcoder2,
  stablelm, phi2, gptneox);
- `cfg.norm_type == "layer"`: mean-subtracted LayerNorm for every block
  norm and the final norm, with `attn_norm_b` / `ffn_norm_b` /
  `output_norm_b` where the file has them (phi2, starcoder2, stablelm,
  gptneox, command-r, nemotron, orion, codeshell, falcon, gptj);
- `cfg.nonparam_norms`: the block and final LayerNorms apply with no
  weight and no bias where the file has no norm tensor (olmo);
- `cfg.clamp_kqv`: q, k and v clipped to +-clamp_kqv after the projection
  and its bias, before rope (olmo, mpt);
- `cfg.rope_dim < head_dim`: only the first `rope_dim` features of q and k
  rotate (phi2, stablelm, gptneox, nemotron, gptj);
- `bo`: the attention output's bias; `w_up` without a gate: the no-gate
  MLP act(x W_up + b_up) W_down + b_down (phi2, starcoder2, gptneox,
  nemotron, codeshell, falcon, gptj), `cfg.act == "relu2"` its squared
  ReLU (nemotron);
- `cfg.parallel_blocks`: x + attn + ffn, the FFN fed by `ffn_norm` where the
  tensor exists (gptneox, stablelm) or by the attention's input norm
  (phi2, command-r, falcon, gptj);
- `output_b` and `cfg.logit_scale` on the logits (phi2, gptj; command-r);
- `attn_q_norm` / `attn_k_norm` [Dh]: per-head RMSNorm of q and k before
  rope (qwen3);
- `post_attn_norm` / `post_ffn_norm`: sandwich norms on the attention and
  FFN outputs before each residual add (gemma2);
- `cfg.embd_scale` on the embeddings (gemma, gemma2), `cfg.attn_scale` on
  the scores, `cfg.attn_softcap` and `cfg.final_softcap` (gemma2);
- `cfg.swa_window` on every `cfg.swa_every`-th layer from layer 0: the mask
  there also hides slots `swa_window` or more behind the query (gemma2). The
  layer index is a Python int, so the choice is made on the host;
- `cfg.rope_dim == 0`: no rotary (gpt2, starcoder, bloom, mpt, refact,
  jais); `pos_embd`: the learned position row added to the embedding
  (gpt2, starcoder); `tok_embd_norm(_b)`: a LayerNorm of the embedding
  (bloom); `cfg.use_alibi`: the scores biased by -slope_h * distance
  (bloom, mpt, refact, jais); `b_gate_up`: the gated FFN's biases (jais);
- `ffn_gate_inp`: the mixture-of-experts FFN in place of the dense one
  (mixtral, qwen2moe; `_moe_ffn`), every expert computed densely and
  combined with the router's zero-masked weights, as the reference does.
Any other architecture's weights or config raise NotImplementedError.

The cache is updated in place: each layer writes its K/V rows into `kv.k` /
`kv.v`, and the returned ForwardOutput carries the same cache object.

Attention reads a bf16 or f32 dense cache through the flash kernels, as the
reference's dispatch (llama.py:516-543) takes its Pallas kernels:
`flash_prefill` for a prompt whose mask is the tags' (not with a window),
`flash_decode` otherwise. A softcapped model (gemma2) and a head width the
kernels do not take (outside 64 / 128 / 256, where the reference's `d % 128`
gate sends it to XLA) read through the plain `ops/attention.py:
gqa_attention`, as the reference's einsums: a choice made from the config
on the host. So does an ALiBi model on every cache form (the reference's
flash gates require `alibi is None`), its key positions the slots' tags. So
do
an int8 cache (its rows quantized as they are written) and a paged pool
(`runtime/paged_kv.py`: written through the row's page table, read as the
mapped pages gathered per row), which the reference reads with XLA's
einsums, outside any Pallas kernel: an int8 dense read dequantizes to bf16,
an int8 paged read to the compute dtype, as the reference's."""

from __future__ import annotations

import functools
import math
import os
from typing import Any, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import gqa_attention
from ..ops.ffn import MAX_ROWS as FFN_MAX_ROWS
from ..ops.ffn import ffn_block, supports_ffn_block
from ..ops.flash_attention import HEAD_DIMS, flash_attention_cached, flash_attention_prefill
from ..ops.matmul import qmatmul, qmatmul_layer
from ..ops.norms import layer_norm, rms_norm
from ..ops.rope import apply_rope, rope_inv_freq, rope_mscale_cfg
from ..quant.qtensor import QTensor
from ..runtime.kvcache import KVCache, dequantize_kv, quantize_kv_vec
from ..runtime.paged_kv import PagedKVCache, gather_pages
from .config import ModelConfig, check_ported

_TOP_KEYS = {"tok_embd", "layers", "output_norm", "output_norm_b", "output", "output_b",
             "rope_factors", "pos_embd", "tok_embd_norm", "tok_embd_norm_b"}
_MOE_KEYS = {"ffn_gate_inp", "w_gate_exps", "w_up_exps", "w_down_exps"}
_SHEXP_KEYS = {"w_gate_shexp", "w_up_shexp", "w_down_shexp"}
_LAYER_KEYS = {"attn_norm", "wqkv", "wo", "ffn_norm", "w_gate_up", "w_up", "w_down", "bqkv",
               "attn_q_norm", "attn_k_norm", "post_attn_norm", "post_ffn_norm",
               "attn_norm_b", "ffn_norm_b", "bo", "b_up", "b_down", "b_gate_up",
               "ffn_gate_inp_shexp"} | _MOE_KEYS | _SHEXP_KEYS


class ForwardOutput(NamedTuple):
    logits: torch.Tensor | None  # [B, T, V]
    hidden: torch.Tensor  # [B, T, D] post-final-norm
    hidden_pre: torch.Tensor  # [B, T, D] last-layer output before the final norm
    kv: KVCache


def check_layer_keys(layers: dict[str, Any], cfg: ModelConfig | None = None) -> None:
    extra = set(layers) - _LAYER_KEYS
    if extra:
        raise NotImplementedError(f"layer weights not ported yet: {sorted(extra)}")
    if "ffn_gate_inp" in layers:  # a MoE layer: the experts replace the dense FFN
        missing = ({"wqkv", "wo"} | _MOE_KEYS) - set(layers)
        dense = {"w_gate_up", "w_up", "w_down", "b_gate_up", "b_up", "b_down"} & set(layers)
        shexp = _SHEXP_KEYS & set(layers)
        if dense or shexp not in (set(), _SHEXP_KEYS) or (
                "ffn_gate_inp_shexp" in layers and not shexp):
            raise NotImplementedError(
                f"a MoE layer with {sorted(dense | shexp)}: only the experts, with or without "
                "a whole shared expert (and its gate), are ported (ROADMAP queue 1, item 8)")
    else:
        missing = {"wqkv", "wo", "w_down"} - set(layers)
        if ("w_gate_up" in layers) == ("w_up" in layers):
            missing.add("w_gate_up or w_up")
        if (_MOE_KEYS | _SHEXP_KEYS | {"ffn_gate_inp_shexp"}) & set(layers):
            missing.add("ffn_gate_inp (the router of the experts)")
    if missing:
        raise NotImplementedError(f"only fused wqkv layers with a fused w_gate_up, a no-gate "
                                  f"w_up or experts are ported; missing {sorted(missing)}")
    if "b_gate_up" in layers and "w_gate_up" not in layers:
        raise NotImplementedError("a gate/up bias without a fused w_gate_up is not ported")
    if "b_up" in layers and "w_up" not in layers:
        # the reference adds b_up to a gated FFN only beside b_gate (jais)
        raise NotImplementedError("an up bias on a gated FFN is not ported (ROADMAP queue 1, "
                                  "item 8)")
    if ("attn_q_norm" in layers) != ("attn_k_norm" in layers):
        raise NotImplementedError("a q norm without a k norm (or the reverse) is not ported")
    if cfg is not None and "attn_q_norm" in layers:
        widths = (layers["attn_q_norm"].shape[-1], layers["attn_k_norm"].shape[-1])
        if widths != (cfg.head_dim, cfg.head_dim):
            # olmo2's one norm over the flat [H * Dh] projection
            raise NotImplementedError(f"q/k norms of widths {widths}: only per-head norms "
                                      f"[{cfg.head_dim}] are ported (ROADMAP queue 1, item 8)")
        if cfg.norm_type == "layer":
            # command-r-plus's q/k LayerNorms: the reference applies RMSNorm
            # there (llama.py:355-357), llama.cpp a LayerNorm
            raise NotImplementedError("q/k norms of a LayerNorm model are not ported "
                                      "(ROADMAP queue 1, item 8)")


def embed_lookup(tok_embd: QTensor | torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Gather embedding rows as f32. A quantized table (an "nk" QTensor, as
    the GGUF loader gives it) is gathered at its quantized width and only the
    gathered rows are dequantized: q * scale (+ bias) in f32."""
    if isinstance(tok_embd, QTensor):
        if tok_embd.layout != "nk" or tok_embd.packed or tok_embd.coded:
            raise NotImplementedError("quantized embedding tables must be unpacked 'nk' "
                                      "with materialized scales")
        g = tok_embd.group
        q = tok_embd.q[tokens].float()  # [..., D]
        d = q.shape[-1]
        out = q.reshape(*q.shape[:-1], d // g, g) * tok_embd.scale[tokens].float()[..., None]
        if tok_embd.bias is not None:
            out = out + tok_embd.bias[tokens].float()[..., None]
        return out.reshape(q.shape)
    return tok_embd[tokens].float()


#: (n_heads, device) -> ALiBi slopes [H] f32 on the device, made once, so a
#: forward captured into a CUDA graph copies nothing from the host
_SLOPES: dict[tuple, torch.Tensor] = {}


def alibi_slopes(n_heads: int, device) -> torch.Tensor:
    """Per-head ALiBi slopes [H] f32 (a copy of eagle_tpu/models/llama.py:
    alibi_slopes: Press et al.'s, as HF and ggml give them at a maximum bias
    of 8): a geometric 2^(-8/n) series over the largest power-of-two head
    count n, then 2^(-4/n)-stepped odd powers for the rest."""
    key = (n_heads, str(torch.device(device)))
    if key not in _SLOPES:
        n = 2 ** math.floor(math.log2(n_heads))
        base = 2.0 ** (-8.0 / n)
        slopes = [base ** (i + 1) for i in range(n)]
        if n < n_heads:
            base2 = 2.0 ** (-4.0 / n)
            slopes += [base2 ** (2 * i + 1) for i in range(n_heads - n)]
        _SLOPES[key] = torch.from_numpy(np.asarray(slopes, np.float32)).to(device)
    return _SLOPES[key]


def position_rows(pos_embd: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """pos_embd[positions] with JAX's gather semantics, as the reference
    indexes it: a negative index wraps once (+ n_pos), then the index is
    clamped into [0, n_pos), so a pad row (position -1) takes the last row
    and a position past the table its last row too. PyTorch's indexing
    raises there on the CPU and asserts on CUDA."""
    n = pos_embd.shape[0]
    idx = torch.where(positions < 0, positions + n, positions).clamp(0, n - 1)
    return pos_embd[idx.long()]


def fused_ffn_mode() -> str:
    """EAGLE_TPU_FUSED_FFN, read once per forward as the reference reads it:
    "0" (default) off, "1" or "all" both fused stages, "wo" the first only."""
    return os.environ.get("EAGLE_TPU_FUSED_FFN", "0")


def _write_rows(cache: torch.Tensor, li: int, slots: torch.Tensor, rows: torch.Tensor) -> None:
    """cache[li, b, :, slots[b, t]] = rows[b, :, t] in place (rows [B, H, T, D],
    or [B, H, T] for an int8 cache's scales)."""
    idx = slots.long()[:, None, :]
    if rows.dim() == 4:
        idx = idx[..., None]
    cache[li].scatter_(2, idx.expand(rows.shape), rows.to(cache.dtype))


def _page_rows(slots: torch.Tensor, page_table: torch.Tensor, page_size: int, scratch: int):
    """(physical page, row in page) [B, T] of each written slot: slot s of
    row b at page_table[b, s // page], row s % page. A slot < 0, at or past
    the table's end, or on an unmapped (-1) entry writes the scratch page
    (PyTorch's index -1 would wrap onto a live page; the reference's clamp
    of a slot past the table onto its last page would overwrite a live
    row)."""
    mp = page_table.shape[1]
    inside = (slots >= 0) & (slots < mp * page_size)
    pg = torch.where(inside, torch.div(slots, page_size, rounding_mode="floor"), 0).long()
    phys = torch.where(inside, torch.gather(page_table, 1, pg), -1)
    phys = torch.where(phys < 0, scratch, phys).long()
    rows = torch.where(inside, slots % page_size, 0).long()
    return phys, rows


def _write_pages(cache: torch.Tensor, li: int, phys: torch.Tensor, rows: torch.Tensor,
                 upd: torch.Tensor) -> None:
    """cache[li, phys[b, t], :, rows[b, t]] = upd[b, :, t] in place (upd
    [B, H, T, D], or [B, H, T] for scales)."""
    cache[li][phys, :, rows] = upd.transpose(1, 2).to(cache.dtype)


def _block_norm(cfg: ModelConfig, layers: dict, key: str, x: torch.Tensor, li: int
                ) -> torch.Tensor:
    """The block norm `key` of layer `li` (the reference's `_block_norm`,
    llama.py:167): RMSNorm, or LayerNorm with the `key + "_b"` bias where the
    layers carry one."""
    w = layers[key][li] if key in layers else None
    if cfg.norm_type == "layer":
        b = layers[key + "_b"][li] if key + "_b" in layers else None
        return layer_norm(x, w, b, cfg.rms_eps)
    return rms_norm(x, w, cfg.rms_eps)


def _relu2(x: torch.Tensor) -> torch.Tensor:
    """The squared ReLU (nemotron's FFN act: the reference's `_relu2`)."""
    r = F.relu(x)
    return r * r


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (2-D, or batched 3-D) with f32 sums and an f32 result, as the
    reference's `preferred_element_type=jnp.float32` einsums: f32 operands
    as they are; compute-dtype operands on the card through cuBLAS with an
    f32 output; on the CPU upcast first (exact products)."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return a @ b
    if not a.is_cuda:
        return a.float() @ b.float()
    mm = torch.mm if a.dim() == 2 else torch.bmm
    return mm(a, b, out_dtype=torch.float32)


def _moe_ffn(cfg: ModelConfig, layers: dict, li: int, x: torch.Tensor, act, compute_dtype
             ) -> torch.Tensor:
    """The mixture-of-experts FFN (the reference's `_moe_ffn`,
    llama.py:81-141): the router's f32 logits, then its weights over the
    experts, every expert computed and combined with them (zero off the
    chosen ones). Mixtral's rule: a softmax over the kept experts;
    `moe_softmax_all` (qwen2moe): a softmax over all, the others zeroed,
    then `expert_weights_norm` / `expert_weights_scale`. An expert is kept
    where its logit is >= the k-th largest (the reference's `top_k(...)[0]
    [..., -1:]`), so a tie at the k-th value keeps more than k. A shared
    expert (`w_*_shexp`) adds to the sum, under a sigmoid gate where
    `ffn_gate_inp_shexp` is given. Gate and up are f32 products of
    compute-dtype operands, h = act(gate) * up in the compute dtype, and
    the down products f32 (`_mm_f32`)."""
    b, t, d = x.shape
    xe = x.reshape(b * t, d).to(compute_dtype)

    def w(key):
        return layers[key][li].to(compute_dtype)

    router = _mm_f32(xe, w("ffn_gate_inp").t())  # [R, E]
    k = max(cfg.n_expert_used, 1)
    kth = torch.topk(router, k, dim=-1).values[..., -1:]
    kept = router >= kth
    if cfg.moe_softmax_all:
        probs = torch.where(kept, torch.softmax(router, dim=-1), 0.0)
        if cfg.expert_weights_norm:
            probs = probs / probs.sum(-1, keepdim=True).clamp_min(1e-20)
        if cfg.expert_weights_scale != 1.0:
            probs = probs * cfg.expert_weights_scale
    else:
        probs = torch.softmax(torch.where(kept, router, float("-inf")), dim=-1)
    wg, wu, wd = w("w_gate_exps"), w("w_up_exps"), w("w_down_exps")
    n_exp, f = wg.shape[0], wg.shape[1]
    gate = _mm_f32(xe, wg.reshape(n_exp * f, d).t()).reshape(-1, n_exp, f)
    up = _mm_f32(xe, wu.reshape(n_exp * f, d).t()).reshape(-1, n_exp, f)
    h = (act(gate) * up).to(compute_dtype)
    out = _mm_f32(h.transpose(0, 1), wd.transpose(1, 2))  # [E, R, D]
    moe = (out * probs.t()[:, :, None]).sum(0)
    if "w_gate_shexp" in layers:  # qwen2moe's shared expert
        g = _mm_f32(xe, w("w_gate_shexp").t())
        u = _mm_f32(xe, w("w_up_shexp").t())
        sh = _mm_f32((act(g) * u).to(compute_dtype), w("w_down_shexp").t())
        if "ffn_gate_inp_shexp" in layers:  # its sigmoid gate
            sh = sh * torch.sigmoid(_mm_f32(xe, w("ffn_gate_inp_shexp").t()))
        moe = moe + sh
    return moe.reshape(b, t, d)


def _ffn(cfg: ModelConfig, layers: dict, li: int, ffn_in: torch.Tensor, compute_dtype
         ) -> torch.Tensor:
    """The FFN (the reference's `_ffn`, llama.py:178-200): the experts
    where the layers carry a router (`_moe_ffn`); the fused gated
    act(gate) * up (with `b_gate_up` added first where the layers carry
    it), or the no-gate MLP act(x W_up + b_up), then W_down and `b_down`
    where the layers carry it."""
    act = (F.silu if cfg.act == "silu" else _relu2 if cfg.act == "relu2"
           else functools.partial(F.gelu, approximate="tanh"))
    if "ffn_gate_inp" in layers:
        return _moe_ffn(cfg, layers, li, ffn_in, act, compute_dtype)
    if "w_gate_up" in layers:
        gate_up = qmatmul_layer(ffn_in, layers["w_gate_up"], li, compute_dtype)
        if "b_gate_up" in layers:  # jais's gate and up biases
            gate_up = gate_up + layers["b_gate_up"][li].to(gate_up.dtype)
        gate, up = gate_up.chunk(2, dim=-1)
        h = act(gate) * up
    else:
        up = qmatmul_layer(ffn_in, layers["w_up"], li, compute_dtype)
        if "b_up" in layers:
            up = up + layers["b_up"][li].to(up.dtype)
        h = act(up)
    out = qmatmul_layer(h, layers["w_down"], li, compute_dtype)
    if "b_down" in layers:
        out = out + layers["b_down"][li].to(out.dtype)
    return out


def _layer_step(
    cfg: ModelConfig,
    inv_freq: torch.Tensor,
    positions: torch.Tensor,  # [B, T]
    slots: torch.Tensor,  # [B, T] cache slots to write (non-negative)
    mask: torch.Tensor,  # [B, T, S_read]
    compute_dtype,
    x: torch.Tensor,  # [B, T, D] f32
    layers: dict[str, Any],  # LAYER-STACKED weights
    li: int,
    k_cache: torch.Tensor,  # [L, B, H_kv, S, Dh] — full stacked cache, written in place
    v_cache: torch.Tensor,
    kv_limit: int | None = None,
    slot_tags: torch.Tensor | None = None,  # [B, S<=lim] tags: prefill kernel
    fused_ffn: str = "0",  # fused_ffn_mode() of the forward
    k_scale: torch.Tensor | None = None,  # int8 caches: [L, B, H_kv, S] (paged: [L, P, H_kv, page])
    v_scale: torch.Tensor | None = None,
    page_table: torch.Tensor | None = None,  # [B, MP]: the caches are page pools
    page_size: int = 0,
    mask_swa: torch.Tensor | None = None,  # [B, T, S_read]: `mask` within the window
    alibi: torch.Tensor | None = None,  # [H] ALiBi slopes
    key_tags: torch.Tensor | None = None,  # [B, >= S_read] the slots' tags (ALiBi)
) -> torch.Tensor:
    """One transformer layer; returns the new residual stream. With
    `fused_ffn` "1"/"all"/"wo", at most 64 rows and weights that
    `supports_ffn_block` admits, the attention output, residual add, FFN
    norm and FFN go through the fused block (ops/ffn.py), as the reference's
    llama.py:549-577 does; otherwise through qmm and plain ops. `mask_swa`
    replaces `mask` on every `cfg.swa_every`-th layer from layer 0. With
    `alibi`, every cache form reads through the plain `gqa_attention`,
    the key positions `key_tags` sliced to the read bound."""
    b, t, _ = x.shape
    h, h_kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn_in = (_block_norm(cfg, layers, "attn_norm", x, li)
               if "attn_norm" in layers or cfg.nonparam_norms else x)
    if mask_swa is not None and li % cfg.swa_every == 0:
        mask = mask_swa

    qkv = qmatmul_layer(attn_in, layers["wqkv"], li, compute_dtype)
    if "bqkv" in layers:  # qwen2's q/k/v biases
        qkv = qkv + layers["bqkv"][li].to(qkv.dtype)
    if cfg.clamp_kqv > 0:  # olmo: q/k/v clipped, a tensor op the step graphs capture
        qkv = qkv.clamp(-cfg.clamp_kqv, cfg.clamp_kqv)
    q, k, v = torch.split(qkv, [h * dh, h_kv * dh, h_kv * dh], dim=-1)
    q = q.reshape(b, t, h, dh)
    k = k.reshape(b, t, h_kv, dh)
    v = v.reshape(b, t, h_kv, dh)
    if "attn_q_norm" in layers:  # qwen3: per-head RMSNorm (weight [Dh]) before rope
        q = rms_norm(q, layers["attn_q_norm"][li], cfg.rms_eps)
        k = rms_norm(k, layers["attn_k_norm"][li], cfg.rms_eps)
    if cfg.rope_dim > 0:  # the position families have no rotary
        ms = rope_mscale_cfg(cfg)
        q = apply_rope(q, positions, inv_freq, ms)
        k = apply_rope(k, positions, inv_freq, ms)
    # the plain read's keyword arguments: an ALiBi bias by the slots' tags
    plain = dict(scale=cfg.attn_scale, softcap=cfg.attn_softcap)
    if alibi is not None:
        plain.update(alibi=alibi, q_pos=positions)

    k_hm, v_hm = k.transpose(1, 2), v.transpose(1, 2)  # [B, H_kv, T, D]
    if k_scale is not None:  # int8: per-vector absmax codes, quantized on write
        (k_hm, k_s), (v_hm, v_s) = quantize_kv_vec(k_hm), quantize_kv_vec(v_hm)
    if page_table is not None:
        phys, rows_w = _page_rows(slots, page_table, page_size, k_cache.shape[1] - 1)
        _write_pages(k_cache, li, phys, rows_w, k_hm)
        _write_pages(v_cache, li, phys, rows_w, v_hm)
        lim = kv_limit if kv_limit is not None else page_table.shape[1] * page_size
        n_read = max(1, -(-lim // page_size))
        k_read = gather_pages(k_cache, li, page_table, n_read)
        v_read = gather_pages(v_cache, li, page_table, n_read)
        if k_scale is not None:
            _write_pages(k_scale, li, phys, rows_w, k_s)
            _write_pages(v_scale, li, phys, rows_w, v_s)
            k_read = dequantize_kv(k_read, gather_pages(k_scale, li, page_table, n_read),
                                   compute_dtype)
            v_read = dequantize_kv(v_read, gather_pages(v_scale, li, page_table, n_read),
                                   compute_dtype)
        n_slots = n_read * page_size
        if alibi is not None:
            plain["k_pos"] = key_tags[:, :n_slots]
        attn = gqa_attention(q, k_read, v_read, mask[..., :n_slots], **plain)
    elif k_scale is not None:
        for cache, upd in ((k_cache, k_hm), (v_cache, v_hm), (k_scale, k_s), (v_scale, v_s)):
            _write_rows(cache, li, slots, upd)
        lim = kv_limit if kv_limit is not None else k_cache.shape[3]
        if alibi is not None:
            plain["k_pos"] = key_tags[:, :lim]
        attn = gqa_attention(q, dequantize_kv(k_cache[li, :, :, :lim], k_scale[li, :, :, :lim]),
                             dequantize_kv(v_cache[li, :, :, :lim], v_scale[li, :, :, :lim]),
                             mask[..., :lim], **plain)
    else:
        _write_rows(k_cache, li, slots, k_hm)
        _write_rows(v_cache, li, slots, v_hm)
        lim = kv_limit if kv_limit is not None else k_cache.shape[3]
        # no flash kernel takes the softcap, ALiBi or a head width outside
        # HEAD_DIMS: the reference reads them through its einsums
        # (llama.py:516-543)
        if cfg.attn_softcap != 0 or alibi is not None or dh not in HEAD_DIMS:
            if alibi is not None:
                plain["k_pos"] = key_tags[:, :lim]
            attn = gqa_attention(q, k_cache[li, :, :, :lim], v_cache[li, :, :, :lim], mask,
                                 **plain)
        elif slot_tags is not None:
            attn = flash_attention_prefill(q, k_cache, v_cache, positions, slot_tags, li,
                                           scale=cfg.attn_scale, s_limit=lim)
        else:
            attn = flash_attention_cached(q, k_cache, v_cache, mask, li,
                                          scale=cfg.attn_scale, s_limit=lim)

    d = x.shape[-1]
    rows = b * t
    if (fused_ffn in ("1", "all", "wo") and rows <= FFN_MAX_ROWS
            and supports_ffn_block(layers, cfg)):
        out = ffn_block(
            attn.reshape(rows, h * dh), x.reshape(rows, d), layers["ffn_norm"][li],
            layers["wo"], layers["w_gate_up"], layers["w_down"], li, rms_eps=cfg.rms_eps,
            act_fn=cfg.act, compute_dtype=compute_dtype,
            stages="wo" if fused_ffn == "wo" else "all",
        )
        return out.reshape(b, t, d)
    attn_out = qmatmul_layer(attn.reshape(b, t, -1), layers["wo"], li, compute_dtype)
    if "bo" in layers:
        attn_out = attn_out + layers["bo"][li].to(attn_out.dtype)
    if "post_attn_norm" in layers:  # gemma2's sandwich norm
        attn_out = rms_norm(attn_out, layers["post_attn_norm"][li], cfg.rms_eps)
    if cfg.parallel_blocks:  # the reference's llama.py:591-602
        ffn_in = _block_norm(cfg, layers, "ffn_norm", x, li) if "ffn_norm" in layers else attn_in
        return x + attn_out + _ffn(cfg, layers, li, ffn_in, compute_dtype)
    x = x + attn_out
    ffn_in = (_block_norm(cfg, layers, "ffn_norm", x, li)
              if "ffn_norm" in layers or cfg.nonparam_norms else x)
    ffn_out = _ffn(cfg, layers, li, ffn_in, compute_dtype)
    if "post_ffn_norm" in layers:
        ffn_out = rms_norm(ffn_out, layers["post_ffn_norm"][li], cfg.rms_eps)
    return x + ffn_out


def read_bound(kv, kv_limit: int | None, mask: torch.Tensor):
    """The forward's attention-read bound and its mask: a paged read
    gathers whole pages, so its bound rounds up to a page (the reference's
    llama.py:701-705) and covers the table without one."""
    if isinstance(kv, PagedKVCache):
        lim = kv.max_seq if kv_limit is None else kv_limit
        kv_limit = min(-(-lim // kv.page_size) * kv.page_size, kv.max_seq)
    if kv_limit is not None:
        kv_limit = min(kv_limit, mask.shape[-1])
        mask = mask[..., :kv_limit]
    return kv_limit, mask


def cache_kw(kv) -> dict:
    """_layer_step's int8 and paged arguments of a cache."""
    kw = dict(k_scale=kv.k_scale, v_scale=kv.v_scale)
    if isinstance(kv, PagedKVCache):
        kw.update(page_table=kv.page_table, page_size=kv.page_size)
    return kw


def llama_forward(
    params: dict[str, Any],
    cfg: ModelConfig,
    tokens: torch.Tensor,  # [B, T] int
    positions: torch.Tensor,  # [B, T] int rope/logical positions
    kv: KVCache,
    slots: torch.Tensor,  # [B, T] cache slot indices to write k/v into
    mask: torch.Tensor,  # [B, T, S] bool — visibility of each cache slot
    *,
    compute_dtype=torch.bfloat16,
    return_logits: bool = True,
    kv_limit: int | None = None,
    slots_contiguous: bool = False,
    causal_tags_prefill: bool = False,  # mask IS causal_mask_from_tags: the
    # prefill kernel rebuilds it from the tags
) -> ForwardOutput:
    """Run the transformer; `kv` is updated in place.

    `hidden` is the post-final-norm hidden state, `hidden_pre` the raw
    last-layer output. `kv_limit` bounds attention reads to cache slots
    [0, kv_limit); writes still address the full cache. `slots_contiguous`
    is accepted for parity with the reference, where it picks a
    dynamic_update_slice over a scatter; here one scatter serves both.
    With a sliding window the prefill kernel is not taken (the reference's
    llama.py:712) and the windowed mask is `mask` less the slots whose index
    lies `swa_window` or more behind the query's position (slot == position
    is the engines' cache invariant, as the reference assumes)."""
    check_ported(cfg)
    extra = set(params) - _TOP_KEYS
    if extra:
        raise NotImplementedError(f"model weights not ported yet: {sorted(extra)}")
    layers = params["layers"]
    check_layer_keys(layers, cfg)
    x = embed_lookup(params["tok_embd"], tokens)
    if cfg.embd_scale != 1.0:  # gemma: embeddings times sqrt(n_embd)
        x = x * cfg.embd_scale
    if cfg.has_pos_embd:  # gpt2 / starcoder learned absolute positions
        x = x + position_rows(params["pos_embd"], positions).to(x.dtype)
    if "tok_embd_norm" in params:  # bloom's embedding LayerNorm
        x = layer_norm(x, params["tok_embd_norm"], params.get("tok_embd_norm_b"), cfg.rms_eps)
    alibi = alibi_slopes(cfg.n_heads, x.device) if cfg.use_alibi else None
    inv_freq = rope_inv_freq(cfg, params.get("rope_factors"), device=x.device)
    kv_limit, mask = read_bound(kv, kv_limit, mask)
    fused = fused_ffn_mode()
    slot_tags = None
    if (causal_tags_prefill and cfg.swa_window == 0 and not isinstance(kv, PagedKVCache)
            and not kv.quantized):
        slot_tags = kv.slot_pos[:, : kv_limit if kv_limit else kv.slot_pos.shape[1]]
    mask_swa = None
    if cfg.swa_window > 0:  # check_ported admits it only with swa_every > 0
        s_idx = torch.arange(mask.shape[-1], dtype=torch.int32, device=mask.device)
        mask_swa = mask & (positions[:, :, None] - s_idx < cfg.swa_window)
    wqkv = layers["wqkv"]  # layer-stacked: a QTensor, or dense f32 from an F32 / F16 file
    for li in range((wqkv.q if isinstance(wqkv, QTensor) else wqkv).shape[0]):
        x = _layer_step(
            cfg, inv_freq, positions, slots, mask, compute_dtype, x, layers, li,
            kv.k, kv.v, kv_limit=kv_limit, slot_tags=slot_tags, fused_ffn=fused,
            mask_swa=mask_swa, alibi=alibi, key_tags=kv.slot_pos, **cache_kw(kv),
        )
    if cfg.norm_type == "layer":
        hidden = layer_norm(x, params.get("output_norm"), params.get("output_norm_b"),
                            cfg.rms_eps)
    else:
        hidden = rms_norm(x, params.get("output_norm"), cfg.rms_eps)
    logits = None
    if return_logits:
        logits = qmatmul(hidden, params["output"], compute_dtype)
        if "output_b" in params:  # phi2's lm_head bias
            logits = logits + params["output_b"].to(logits.dtype)
        if cfg.logit_scale != 1.0:  # command-r
            logits = logits * cfg.logit_scale
        if cfg.final_softcap > 0:  # gemma2's final logit softcapping
            c = cfg.final_softcap
            logits = c * torch.tanh(logits / c)
    return ForwardOutput(logits=logits, hidden=hidden, hidden_pre=x, kv=kv)
