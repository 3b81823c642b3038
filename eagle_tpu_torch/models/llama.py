"""Llama forward pass, plain pre-norm block (port of
eagle_tpu/models/llama.py: `ForwardOutput`, `embed_lookup`, `_layer_step`,
`llama_forward`, with the int8 and paged cache branches, Llama-3.1's rope
factors and a tied ("nk") head).

RMSNorm, rotary GQA attention over the position-tagged cache, SiLU-gated FFN,
with fused `wqkv` and `w_gate_up` weights kept layer-stacked and read in
place by the qmm kernel. One function serves prefill, decode and speculative
verify. Any other architecture's weights or config raise
NotImplementedError.

The cache is updated in place: each layer writes its K/V rows into `kv.k` /
`kv.v`, and the returned ForwardOutput carries the same cache object.

Attention reads a bf16 or f32 dense cache through the flash kernels. An
int8 cache (its rows quantized as they are written) and a paged pool
(`runtime/paged_kv.py`: written through the row's page table, read as the
mapped pages gathered per row) are read through the plain
`ops/attention.py:gqa_attention`, as the reference reads both with XLA's
einsums, outside any Pallas kernel: an int8 dense read dequantizes to bf16,
an int8 paged read to the compute dtype, as the reference's."""

from __future__ import annotations

import os
from typing import Any, NamedTuple

import torch
import torch.nn.functional as F

from ..ops.attention import gqa_attention
from ..ops.ffn import MAX_ROWS as FFN_MAX_ROWS
from ..ops.ffn import ffn_block, supports_ffn_block
from ..ops.flash_attention import flash_attention_cached, flash_attention_prefill
from ..ops.matmul import qmatmul, qmatmul_layer
from ..ops.norms import rms_norm
from ..ops.rope import apply_rope, rope_inv_freq, rope_mscale_cfg
from ..quant.qtensor import QTensor
from ..runtime.kvcache import KVCache, dequantize_kv, quantize_kv_vec
from ..runtime.paged_kv import PagedKVCache, gather_pages
from .config import ModelConfig, check_plain_llama

_TOP_KEYS = {"tok_embd", "layers", "output_norm", "output", "rope_factors"}
_LAYER_KEYS = {"attn_norm", "wqkv", "wo", "ffn_norm", "w_gate_up", "w_down"}


class ForwardOutput(NamedTuple):
    logits: torch.Tensor | None  # [B, T, V]
    hidden: torch.Tensor  # [B, T, D] post-final-norm
    hidden_pre: torch.Tensor  # [B, T, D] last-layer output before the final norm
    kv: KVCache


def check_layer_keys(layers: dict[str, Any]) -> None:
    extra = set(layers) - _LAYER_KEYS
    if extra:
        raise NotImplementedError(f"layer weights not ported yet: {sorted(extra)}")
    missing = {"wqkv", "wo", "w_gate_up", "w_down"} - set(layers)
    if missing:
        raise NotImplementedError(f"only fused wqkv / w_gate_up layers are ported; missing {sorted(missing)}")


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
) -> torch.Tensor:
    """One transformer layer; returns the new residual stream. With
    `fused_ffn` "1"/"all"/"wo", at most 64 rows and weights that
    `supports_ffn_block` admits, the attention output, residual add, FFN
    norm and FFN go through the fused block (ops/ffn.py), as the reference's
    llama.py:549-577 does; otherwise through qmm and plain ops."""
    b, t, _ = x.shape
    h, h_kv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    attn_in = rms_norm(x, layers["attn_norm"][li], cfg.rms_eps) if "attn_norm" in layers else x

    qkv = qmatmul_layer(attn_in, layers["wqkv"], li, compute_dtype)
    q, k, v = torch.split(qkv, [h * dh, h_kv * dh, h_kv * dh], dim=-1)
    q = q.reshape(b, t, h, dh)
    k = k.reshape(b, t, h_kv, dh)
    v = v.reshape(b, t, h_kv, dh)
    ms = rope_mscale_cfg(cfg)
    q = apply_rope(q, positions, inv_freq, ms)
    k = apply_rope(k, positions, inv_freq, ms)

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
        attn = gqa_attention(q, k_read, v_read, mask[..., :n_read * page_size],
                             scale=cfg.attn_scale)
    elif k_scale is not None:
        for cache, upd in ((k_cache, k_hm), (v_cache, v_hm), (k_scale, k_s), (v_scale, v_s)):
            _write_rows(cache, li, slots, upd)
        lim = kv_limit if kv_limit is not None else k_cache.shape[3]
        attn = gqa_attention(q, dequantize_kv(k_cache[li, :, :, :lim], k_scale[li, :, :, :lim]),
                             dequantize_kv(v_cache[li, :, :, :lim], v_scale[li, :, :, :lim]),
                             mask[..., :lim], scale=cfg.attn_scale)
    else:
        _write_rows(k_cache, li, slots, k_hm)
        _write_rows(v_cache, li, slots, v_hm)
        lim = kv_limit if kv_limit is not None else k_cache.shape[3]
        if slot_tags is not None:
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
    x = x + qmatmul_layer(attn.reshape(b, t, -1), layers["wo"], li, compute_dtype)
    ffn_in = rms_norm(x, layers["ffn_norm"][li], cfg.rms_eps) if "ffn_norm" in layers else x
    gate_up = qmatmul_layer(ffn_in, layers["w_gate_up"], li, compute_dtype)
    gate, up = gate_up.chunk(2, dim=-1)
    return x + qmatmul_layer(F.silu(gate) * up, layers["w_down"], li, compute_dtype)


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
    dynamic_update_slice over a scatter; here one scatter serves both."""
    check_plain_llama(cfg)
    extra = set(params) - _TOP_KEYS
    if extra:
        raise NotImplementedError(f"model weights not ported yet: {sorted(extra)}")
    layers = params["layers"]
    check_layer_keys(layers)
    x = embed_lookup(params["tok_embd"], tokens)
    inv_freq = rope_inv_freq(cfg, params.get("rope_factors"), device=x.device)
    kv_limit, mask = read_bound(kv, kv_limit, mask)
    fused = fused_ffn_mode()
    slot_tags = None
    if causal_tags_prefill and not isinstance(kv, PagedKVCache) and not kv.quantized:
        slot_tags = kv.slot_pos[:, : kv_limit if kv_limit else kv.slot_pos.shape[1]]
    wqkv = layers["wqkv"]  # layer-stacked: a QTensor, or dense f32 from an F32 / F16 file
    for li in range((wqkv.q if isinstance(wqkv, QTensor) else wqkv).shape[0]):
        x = _layer_step(
            cfg, inv_freq, positions, slots, mask, compute_dtype, x, layers, li,
            kv.k, kv.v, kv_limit=kv_limit, slot_tags=slot_tags, fused_ffn=fused,
            **cache_kw(kv),
        )
    hidden = rms_norm(x, params.get("output_norm"), cfg.rms_eps)
    logits = qmatmul(hidden, params["output"], compute_dtype) if return_logits else None
    return ForwardOutput(logits=logits, hidden=hidden, hidden_pre=x, kv=kv)
