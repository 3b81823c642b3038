"""Masked GQA attention over a position-tagged KV cache (port of
eagle_tpu/ops/attention.py:gqa_attention, with its softcap and its ALiBi
bias).

This is the plain path on the CPU, the plain version of both flash kernels
(ops/flash_attention.py), and on the card the attention of a softcapped
model (gemma2), of an ALiBi model (bloom, mpt, refact, jais) and of the
int8 and paged caches, as the reference's."""

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
    alibi: torch.Tensor | None = None,  # [H] per-head ALiBi slopes
    q_pos: torch.Tensor | None = None,  # [B, T] query positions (ALiBi only)
    k_pos: torch.Tensor | None = None,  # [B, S] key positions: the slots' tags (ALiBi only)
) -> torch.Tensor:
    """Returns [B, T, H, D] f32. q is rounded to the cache dtype; QK and PV
    products accumulate in f32 (cache values are exact in f32); the softmax
    is f32 and its probabilities are rounded to the cache dtype for PV. A
    `softcap` > 0 maps the scaled scores to softcap * tanh(s / softcap)
    before the mask. With `alibi`, each head's scores drop by
    slope_h * (q_pos - k_pos) in f32 after the scale and before the mask.
    The key's position is its slot's tag, as llama.cpp takes it from its
    cells: the reference takes the slot index, which is the same wherever
    a slot holds its own position, and not in a tree verify (node j at slot
    base + j, position base + depth j) or after Self-Extend's remap."""
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
    if alibi is not None:
        dist = (q_pos[:, :, None] - k_pos[:, None, :]).float()  # [B, T, S]
        slopes = alibi.float().reshape(1, h_kv, group, 1, 1)
        scores = scores - slopes * dist[:, None, None, :, :]
    scores = torch.where(mask[:, None, None, :, :], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgts,bksd->btkgd", probs.to(cdt).float(), v_cache.float())
    return out.reshape(b, t, h, v_cache.shape[-1])
