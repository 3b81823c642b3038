"""KV cache — static-shape, position-tagged (port of
eagle_tpu/runtime/kvcache.py: `KVCache.create`, `with_tags`, `rollback`,
`causal_mask_from_tags`, `quantize_kv_vec`, `dequantize_kv`,
`context_shift` and `self_extend_shift`, for bf16, f32 and int8 caches).

The cache is k/v [L, B, H_kv, S, D] plus a per-slot position tag array
`slot_pos` [B, S] (-1 = empty). Masks are computed from the tags; rollback
after speculation rewrites tags only, never K/V data.

Unlike the functional reference, the port updates in place: `with_tags` and
`rollback` modify `slot_pos` and return the same cache, and the model
forward writes K/V rows into `k`/`v` directly.

A cache may carry `spill` slots past its `max_seq` (k/v [L, B, H_kv, S +
spill, D], tags [B, S + spill]): the reference's scatter drops a write past
the cache, PyTorch's `scatter_` cannot, so such writes land there. No read
covers them: every attention bound (`kv_limit`) is at most `max_seq`.

An int8 cache holds per-vector symmetric codes in k/v and their f32 absmax
scales in `k_scale` / `v_scale` [L, B, H_kv, S + spill]: each K or V row is
quantized as it is written and dequantized where it is read, as the
reference's (its codes and scales are bit-equal to the reference's)."""

from __future__ import annotations

import dataclasses

import torch

from .._device import resolve_device
from ..ops.rope import apply_rope


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor  # [L, B, H_kv, S, D]
    v: torch.Tensor  # [L, B, H_kv, S, D]
    slot_pos: torch.Tensor  # [B, S] int32, position tag per slot, -1 = empty
    spill: int = 0  # slots past max_seq that take writes past the cache
    k_scale: torch.Tensor | None = None  # [L, B, H_kv, S] f32: int8 caches only
    v_scale: torch.Tensor | None = None

    @property
    def max_seq(self) -> int:
        return self.k.shape[3] - self.spill

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @staticmethod
    def create(n_layers, batch, max_seq, n_kv_heads, head_dim, dtype=torch.bfloat16,
               device="cuda", spill: int = 0) -> "KVCache":
        dev = resolve_device(device)
        if dtype not in (torch.bfloat16, torch.float32, torch.int8):
            raise NotImplementedError(f"KV cache dtype {dtype} is not ported")
        shape = (n_layers, batch, n_kv_heads, max_seq + spill, head_dim)
        scales = {}
        if dtype == torch.int8:
            scales = {n: torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
                      for n in ("k_scale", "v_scale")}
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=dev),
            v=torch.zeros(shape, dtype=dtype, device=dev),
            slot_pos=torch.full((batch, max_seq + spill), -1, dtype=torch.int32, device=dev),
            spill=spill, **scales,
        )

    def tensors(self) -> tuple[torch.Tensor, ...]:
        """Every device tensor of the cache (a graph's static inputs)."""
        return tuple(t for t in (self.k, self.v, self.slot_pos, self.k_scale, self.v_scale)
                     if t is not None)

    def reset(self) -> None:
        """Zeros and empty tags, in place."""
        for t in self.tensors():
            t.zero_()
        self.slot_pos.fill_(-1)

    def row(self, i: int) -> "KVCache":
        """Batch row i as a B = 1 cache of views: writes go to this cache."""
        def take(t):
            return None if t is None else t[:, i:i + 1]

        return KVCache(self.k[:, i:i + 1], self.v[:, i:i + 1], self.slot_pos[i:i + 1],
                       self.spill, take(self.k_scale), take(self.v_scale))

    def with_tags(self, slots: torch.Tensor, positions: torch.Tensor, valid=None) -> "KVCache":
        """Tag `slots` [B,T] with `positions` [B,T] in place (the K/V write
        happens in the model forward; tags define visibility). `valid` [B,T]
        bool tags masked-out entries -1. Slots must lie in [0, S + spill):
        the reference's scatter drops an out-of-range slot, while `scatter_`
        raises on the CPU and hits a device-side assert on CUDA. The callers
        never build a negative slot: prefill slots are an `arange`, decode
        slots start at the prompt length and draft slots one below it, both
        `generate`s refuse an empty prompt, and a prompt chunk sends its rows
        outside [0, S) to the last spill slot (`EagleChainEngine.
        _prefill_chunk`)."""
        pos = positions if valid is None else torch.where(valid, positions, -1)
        self.slot_pos.scatter_(1, slots.long(), pos.to(torch.int32))
        return self

    def rollback(self, keep_below: torch.Tensor) -> "KVCache":
        """Invalidate, in place, every slot whose position >= keep_below [B]
        (the KV rollback after speculative verification)."""
        self.slot_pos.masked_fill_(self.slot_pos >= keep_below[:, None], -1)
        return self


def causal_mask_from_tags(slot_pos: torch.Tensor, q_positions: torch.Tensor,
                          swa_window: int = 0) -> torch.Tensor:
    """Boolean attention mask [B, T, S]: slot visible iff non-empty and its
    position <= the query token's position; with `swa_window` > 0 also
    less than `swa_window` positions behind it (the reference's
    kvcache.py:198)."""
    vis = (slot_pos[:, None, :] >= 0) & (slot_pos[:, None, :] <= q_positions[:, :, None])
    if swa_window > 0:
        vis = vis & (q_positions[:, :, None] - slot_pos[:, None, :] < swa_window)
    return vis


def quantize_kv_vec(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-vector symmetric int8: x [..., D] -> (codes int8 [..., D], scale
    f32 [...]), the reference's arithmetic: the f32 absmax over 127, its f32
    reciprocal (0 for an all-zero vector), round half to even, clip to
    +-127."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    # a tensor divisor: PyTorch on CUDA divides by a Python scalar as a
    # product with its reciprocal, which is not the reference's quotient
    scale = amax / torch.full_like(amax, 127.0)
    inv = torch.where(scale > 0, 1.0 / torch.where(scale == 0, 1.0, scale), 0.0)
    codes = torch.clamp(torch.round(xf * inv[..., None]), -127, 127)
    return codes.to(torch.int8), scale


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """codes int8 [..., D] x scale [...] -> dense [..., D] in `dtype`: the
    codes and the scale each cast to `dtype`, then multiplied there."""
    return codes.to(dtype) * scale.to(dtype)[..., None]


def _rotate_keys(kv: KVCache, k: torch.Tensor, positions: torch.Tensor, inv_freq,
                 scale: torch.Tensor | None):
    """Rotate keys k [L, B, H, T, D] (views into kv.k) by `positions`
    (broadcastable to [L, B, T]): a float cache on its own values cast back
    to its dtype, an int8 cache dequantized to f32, rotated and requantized.
    Returns (keys, their scales or None), to be written by the caller. An
    empty `inv_freq` (no rotary: learned positions or ALiBi) leaves the keys,
    codes and scales as they are: copies, since the caller's target range
    may overlap theirs."""
    if inv_freq.shape[-1] == 0:
        return k.clone(), None if scale is None else scale.clone()
    src = k if scale is None else dequantize_kv(k, scale, torch.float32)
    out = apply_rope(src.transpose(2, 3), positions, inv_freq).transpose(2, 3)
    if scale is None:
        return out, None
    return quantize_kv_vec(out)


def context_shift(kv: KVCache, inv_freq: torch.Tensor, n_keep: int, n_discard: int) -> KVCache:
    """Evict `n_discard` tokens after the first `n_keep`, slide the rest down
    and re-rotate the moved keys by -n_discard positions, in place (llama.cpp's
    context shift, main.cpp:553-577). The keys are roped on the cache dtype's
    values and cast back, as the reference's `astype(buf.dtype)`; an int8
    cache's keys are dequantized, rotated and requantized, its V codes and
    scales move as they are. The tags of the moved slots drop by n_discard
    and the tail that slid away empties. The source and target ranges
    overlap, so the moved rows go through a temporary. Slots past `max_seq`
    (the spill) are untouched. Each moved slot's tag drops with its index,
    so a cache whose slots held their own positions still does: an ALiBi
    distance (tag to tag) is what a recompute at the new positions gives,
    and without rotary the keys move as they are."""
    s = kv.max_seq
    start = n_keep + n_discard
    if n_keep < 0 or n_discard <= 0 or start > s:
        raise ValueError(f"context shift keep={n_keep} discard={n_discard} on {s} slots")
    m = s - start
    neg = torch.full((m,), -n_discard, dtype=torch.int32, device=kv.k.device)
    k_sc = None if kv.k_scale is None else kv.k_scale[:, :, :, start:s]
    keys, scales = _rotate_keys(kv, kv.k[:, :, :, start:s], neg, inv_freq, k_sc)
    kv.k[:, :, :, n_keep:n_keep + m] = keys
    kv.v[:, :, :, n_keep:n_keep + m] = kv.v[:, :, :, start:s].clone()
    if kv.quantized:
        kv.k_scale[:, :, :, n_keep:n_keep + m] = scales
        kv.v_scale[:, :, :, n_keep:n_keep + m] = kv.v_scale[:, :, :, start:s].clone()
    tags = kv.slot_pos[:, start:s]
    kv.slot_pos[:, n_keep:n_keep + m] = torch.where(tags >= 0, tags - n_discard, -1)
    kv.slot_pos[:, s - n_discard:s] = -1
    return kv


def self_extend_shift(kv: KVCache, inv_freq: torch.Tensor, n_past: int, ga_i: int,
                      ga_n: int, ga_w: int) -> tuple[int, int]:
    """One Self-Extend group-attention step, in place (main.cpp:590-608's
    seq_add / seq_div / seq_add triple with the deferred K re-rope):

        add [ga_i, n_past) += ib*bd
        div [ga_i+ib*bd, ga_i+ib*bd+ga_w) /= ga_n
        add [ga_i+ib*bd+ga_w, n_past+ib*bd) += dd

    The position tags are remapped and each cached key rotated by its slot's
    delta (an int8 cache dequantized, rotated and requantized, every slot as
    in the reference); slots never move and the cache keeps its pointers.
    Returns (new n_past, new ga_i)."""
    ib = (ga_n * ga_i) // ga_w
    bd = (ga_w // ga_n) * (ga_n - 1)
    dd = (ga_w // ga_n) - ib * bd - ga_w

    pos = kv.slot_pos  # [B, S]
    live = pos >= 0
    in1 = live & (pos >= ga_i) & (pos < n_past)
    p1 = torch.where(in1, pos + ib * bd, pos)
    lo = ga_i + ib * bd
    in2 = live & (p1 >= lo) & (p1 < lo + ga_w)
    p = torch.where(in2, torch.div(p1, ga_n, rounding_mode="floor"), p1)
    in3 = live & (p1 >= lo + ga_w) & (p1 < n_past + ib * bd)
    p = torch.where(in3, p + dd, p)
    delta = torch.where(live, p - pos, 0)  # [B, S]
    keys, scales = _rotate_keys(kv, kv.k, delta[None], inv_freq, kv.k_scale)
    kv.k.copy_(keys)
    if scales is not None:
        kv.k_scale.copy_(scales)
    kv.slot_pos.copy_(p.to(torch.int32))
    return n_past - bd, ga_i + ga_w // ga_n
