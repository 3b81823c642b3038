"""KV cache — static-shape, position-tagged (port of
eagle_tpu/runtime/kvcache.py: `KVCache.create`, `with_tags`, `rollback`,
`causal_mask_from_tags` and `context_shift` for bf16 and f32 caches).

The cache is k/v [L, B, H_kv, S, D] plus a per-slot position tag array
`slot_pos` [B, S] (-1 = empty). Masks are computed from the tags; rollback
after speculation rewrites tags only, never K/V data.

Unlike the functional reference, the port updates in place: `with_tags` and
`rollback` modify `slot_pos` and return the same cache, and the model
forward writes K/V rows into `k`/`v` directly.

A cache may carry `spill` slots past its `max_seq` (k/v [L, B, H_kv, S +
spill, D], tags [B, S + spill]): the reference's scatter drops a write past
the cache, PyTorch's `scatter_` cannot, so such writes land there. No read
covers them: every attention bound (`kv_limit`) is at most `max_seq`."""

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

    @property
    def max_seq(self) -> int:
        return self.k.shape[3] - self.spill

    @staticmethod
    def create(n_layers, batch, max_seq, n_kv_heads, head_dim, dtype=torch.bfloat16,
               device="cuda", spill: int = 0) -> "KVCache":
        dev = resolve_device(device)
        if dtype not in (torch.bfloat16, torch.float32):
            raise NotImplementedError(f"KV cache dtype {dtype} is not ported yet")
        shape = (n_layers, batch, n_kv_heads, max_seq + spill, head_dim)
        return KVCache(
            k=torch.zeros(shape, dtype=dtype, device=dev),
            v=torch.zeros(shape, dtype=dtype, device=dev),
            slot_pos=torch.full((batch, max_seq + spill), -1, dtype=torch.int32, device=dev),
            spill=spill,
        )

    def row(self, i: int) -> "KVCache":
        """Batch row i as a B = 1 cache of views: writes go to this cache."""
        return KVCache(self.k[:, i:i + 1], self.v[:, i:i + 1], self.slot_pos[i:i + 1],
                       self.spill)

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


def causal_mask_from_tags(slot_pos: torch.Tensor, q_positions: torch.Tensor) -> torch.Tensor:
    """Boolean attention mask [B, T, S]: slot visible iff non-empty and its
    position <= the query token's position."""
    return (slot_pos[:, None, :] >= 0) & (slot_pos[:, None, :] <= q_positions[:, :, None])


def context_shift(kv: KVCache, inv_freq: torch.Tensor, n_keep: int, n_discard: int) -> KVCache:
    """Evict `n_discard` tokens after the first `n_keep`, slide the rest down
    and re-rotate the moved keys by -n_discard positions, in place (llama.cpp's
    context shift, main.cpp:553-577). The keys are roped on the cache dtype's
    values and cast back, as the reference's `astype(buf.dtype)`; the tags of
    the moved slots drop by n_discard and the tail that slid away empties.
    The source and target ranges overlap, so the moved rows go through a
    temporary. Slots past `max_seq` (the spill) are untouched."""
    s = kv.max_seq
    start = n_keep + n_discard
    if n_keep < 0 or n_discard <= 0 or start > s:
        raise ValueError(f"context shift keep={n_keep} discard={n_discard} on {s} slots")
    m = s - start
    # [L, B, H, m, D] -> [L, B, m, H, D]: apply_rope's [..., T, H, D]
    moved = kv.k[:, :, :, start:s].transpose(2, 3)
    neg = torch.full((m,), -n_discard, dtype=torch.int32, device=kv.k.device)
    kv.k[:, :, :, n_keep:n_keep + m] = apply_rope(moved, neg, inv_freq).transpose(2, 3)
    kv.v[:, :, :, n_keep:n_keep + m] = kv.v[:, :, :, start:s].clone()
    tags = kv.slot_pos[:, start:s]
    kv.slot_pos[:, n_keep:n_keep + m] = torch.where(tags >= 0, tags - n_discard, -1)
    kv.slot_pos[:, s - n_discard:s] = -1
    return kv
