"""Masked GQA attention over a position-tagged KV cache (port of
eagle_tpu/ops/attention.py:gqa_attention, without ALiBi).

This is the plain path on the CPU, the plain version of both flash kernels
(ops/flash_attention.py), and on the card the attention of a softcapped
model (gemma2) and of the int8 and paged caches, as the reference's."""

from __future__ import annotations

import torch

_NEG_INF = -1e30  # large-negative instead of -inf: fully masked rows stay NaN-free


def gqa_attention(
    q: torch.Tensor,  # [B, T, H, D]
    k_cache: torch.Tensor,  # [B, H_kv, S, D] (head-major)
    v_cache: torch.Tensor,  # [B, H_kv, S, D]
    mask: torch.Tensor,  # [B, T, S] bool
    scale: float | None = None,
    softcap: float = 0.0,  # gemma2's attn_logit_softcapping
) -> torch.Tensor:
    """Returns [B, T, H, D] f32. q is rounded to the cache dtype; QK and PV
    products accumulate in f32 (cache values are exact in f32); the softmax
    is f32 and its probabilities are rounded to the cache dtype for PV. A
    `softcap` > 0 maps the scaled scores to softcap * tanh(s / softcap)
    before the mask."""
    b, t, h, d = q.shape
    h_kv = k_cache.shape[1]
    group = h // h_kv
    if scale is None:
        scale = d**-0.5
    cdt = k_cache.dtype
    qc = q.to(cdt).float().reshape(b, t, h_kv, group, d)
    scores = torch.einsum("btkgd,bksd->bkgts", qc, k_cache.float()) * scale
    if softcap > 0:
        scores = softcap * torch.tanh(scores / softcap)
    scores = torch.where(mask[:, None, None, :, :], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bksd->btkgd", probs.to(cdt).float(), v_cache.float())
    return out.reshape(b, t, h, v_cache.shape[-1])
