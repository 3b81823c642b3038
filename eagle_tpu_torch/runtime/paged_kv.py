"""Paged KV pool, the serving-scale cache (port of
eagle_tpu/runtime/paged_kv.py: `PagedKVCache`, `PagePool`,
`copy_pool_page(s)` and `gather_pages`).

Layout
------
- pool      k/v [L, P + 1, H_kv, page, D]: P allocatable pages shared by
            every batch row, and one more, the scratch page, at index P
            (never allocated, never read: unmapped writes land there)
- page map  page_table [B, MP] int32: slot-local page -> pool page, -1 =
            unmapped
- tags      slot_pos [B, MP*page + spill] int32, with the dense cache's
            semantics, so the engines' tag code (rollback, masks, prompt
            chunks) runs unchanged on a paged cache
- int8      k_scale / v_scale [L, P + 1, H_kv, page] f32 for an int8 pool

Logical slot s of row b lives at pool page page_table[b, s // page], row
s % page. The model forward (models/llama.py:_layer_step) writes through
the table and reads the mapped pages gathered into a per-row view. A slot
at or past MP*page (the `spill` columns of the tags take its tag, as the
dense cache's spill slots do), a slot < 0, or an unmapped (-1) table entry
writes the scratch page: the reference clamps a slot past the table onto
the row's last page, which would overwrite a live row of it.

As the port's dense cache, the pool is updated in place: `with_tags`,
`rollback`, `copy_pool_page(s)` and the forward's writes modify it and keep
its data pointers, so graphs captured over it replay. The host-side
`PagePool` is the reference's, line for line."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device


@dataclasses.dataclass
class PagedKVCache:
    k: torch.Tensor  # [L, P + 1, H_kv, page, D]
    v: torch.Tensor
    page_table: torch.Tensor  # [B, MP] int32, -1 = unmapped
    slot_pos: torch.Tensor  # [B, MP*page + spill] int32 position tags, -1 = empty
    page_size: int = 64
    spill: int = 0  # tag columns past max_seq: their writes go to the scratch page
    k_scale: torch.Tensor | None = None  # [L, P + 1, H_kv, page] f32: int8 pools only
    v_scale: torch.Tensor | None = None

    @property
    def max_seq(self) -> int:
        return self.page_table.shape[1] * self.page_size

    @property
    def n_pages(self) -> int:
        """Allocatable pages: the pool's last page is the scratch page."""
        return self.k.shape[1] - 1

    @property
    def scratch_page(self) -> int:
        return self.k.shape[1] - 1

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @staticmethod
    def create(n_layers, batch, n_pages, pages_per_slot, page_size, n_kv_heads, head_dim,
               dtype=torch.bfloat16, device="cuda", spill: int = 0) -> "PagedKVCache":
        """`n_pages` usable pages plus the scratch page at index n_pages."""
        dev = resolve_device(device)
        if dtype not in (torch.bfloat16, torch.float32, torch.int8):
            raise NotImplementedError(f"KV cache dtype {dtype} is not ported")
        shape = (n_layers, n_pages + 1, n_kv_heads, page_size, head_dim)
        scales = {}
        if dtype == torch.int8:
            scales = {n: torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
                      for n in ("k_scale", "v_scale")}
        return PagedKVCache(
            k=torch.zeros(shape, dtype=dtype, device=dev),
            v=torch.zeros(shape, dtype=dtype, device=dev),
            page_table=torch.full((batch, pages_per_slot), -1, dtype=torch.int32, device=dev),
            slot_pos=torch.full((batch, pages_per_slot * page_size + spill), -1,
                                dtype=torch.int32, device=dev),
            page_size=page_size, spill=spill, **scales,
        )

    def tensors(self) -> tuple[torch.Tensor, ...]:
        """Every device tensor of the cache (a graph's static inputs)."""
        return tuple(t for t in (self.k, self.v, self.slot_pos, self.page_table, self.k_scale,
                                 self.v_scale) if t is not None)

    def reset(self) -> None:
        """Zeros, empty tags and unmapped tables, in place."""
        for t in self.tensors():
            t.zero_()
        self.slot_pos.fill_(-1)
        self.page_table.fill_(-1)

    def row(self, i: int) -> "PagedKVCache":
        """Batch row i as a B = 1 cache: its table and tag rows as views,
        the whole pool shared (writes go through the row's table)."""
        return dataclasses.replace(self, page_table=self.page_table[i:i + 1],
                                   slot_pos=self.slot_pos[i:i + 1])

    # --- tag ops: the dense KVCache's semantics, in place -----------------

    def with_tags(self, slots: torch.Tensor, positions: torch.Tensor,
                  valid=None) -> "PagedKVCache":
        pos = positions if valid is None else torch.where(valid, positions, -1)
        self.slot_pos.scatter_(1, slots.long(), pos.to(torch.int32))
        return self

    def rollback(self, keep_below: torch.Tensor) -> "PagedKVCache":
        self.slot_pos.masked_fill_(self.slot_pos >= keep_below[:, None], -1)
        return self


class PagePool:
    """Host-side page allocator: free list + refcounts + full-page prefix
    cache (identity of shared content is the token chain).

    Pages enter the prefix cache when a prompt finishes prefill; cached
    pages carry one extra reference so they survive their owner. When
    allocation fails, cached-only pages are evicted LRU."""

    def __init__(self, n_pages: int, page_size: int):
        self.page_size = page_size
        self.n_pages = n_pages
        self.free: list[int] = list(range(n_pages - 1, -1, -1))
        self.ref = np.zeros(n_pages, np.int32)
        # prefix cache: token chain -> page id, insertion-ordered for LRU
        self._cache: dict = {}
        self._cache_of_page: dict[int, object] = {}
        # optional per-entry payload (the paged batcher stores the EAGLE
        # boundary feature of each page's last token)
        self._payload: dict = {}
        # copy-on-write index for shift-keyed pools: the same pages keyed by
        # their chain WITHOUT the shift tail (match_cow); no refs of its own
        self._cow: dict = {}
        self._cow_of_page: dict[int, object] = {}

    # -- raw page ops ------------------------------------------------------

    def available(self) -> int:
        return len(self.free) + sum(
            1 for p, h in self._cache_of_page.items() if self.ref[p] == 1
        )

    def alloc(self) -> int:
        if not self.free:
            self._evict_one()
        page = self.free.pop()
        self.ref[page] = 1
        return page

    def retain(self, page: int):
        self.ref[page] += 1

    def release(self, page: int):
        assert self.ref[page] > 0, page
        self.ref[page] -= 1
        if self.ref[page] == 0:
            self.free.append(page)

    def _evict_one(self):
        for h, page in list(self._cache.items()):  # insertion order = LRU
            if self.ref[page] == 1:  # held only by the cache
                del self._cache[h]
                del self._cache_of_page[page]
                self._payload.pop(h, None)
                ck = self._cow_of_page.pop(page, None)
                if ck is not None:
                    self._cow.pop(ck, None)
                    # another cached page may share this stripped chain (same
                    # span, another shift tail): re-point the cow key to it
                    for k2, p2 in self._cache.items():
                        if (p2 != page and len(k2) > len(ck)
                                and len(k2) - len(ck) < self.page_size
                                and k2[: len(ck)] == ck):
                            self._cow[ck] = p2
                            self._cow_of_page[p2] = ck
                            break
                self.release(page)
                if self.free:
                    return
        if not self.free:
            raise MemoryError("KV page pool exhausted")

    def is_shared(self, page: int) -> bool:
        """True when writing `page` could be seen by anyone but its one
        holder: another reference, or the prefix cache."""
        return self.ref[page] > 1 or page in self._cache_of_page

    # -- prefix sharing ----------------------------------------------------

    def _chain_keys(self, tokens, shift: int = 0) -> list:
        """Exact key per FULL page of the token prefix: key i is the token
        tuple tokens[: (i+1)*page + shift] itself (no hash, no collision).
        The EAGLE draft row at position p holds (x_{p+1}, f_p), so draft
        pages are keyed with shift=1."""
        toks = tuple(int(t) for t in tokens)
        out = []
        for i in range((len(toks) - shift) // self.page_size):
            out.append(toks[: (i + 1) * self.page_size + shift])
        return out

    def match_prefix(self, tokens, want_payloads: bool = False, shift: int = 0):
        """Longest cached full-page prefix of `tokens`: (n_shared_tokens,
        page_ids[, payloads]), every returned page retained for the
        caller."""
        pages: list[int] = []
        payloads: list = []
        for key in self._chain_keys(tokens, shift):
            page = self._cache.get(key)
            if page is None:
                break
            self._cache.pop(key)  # re-insert: LRU touch
            self._cache[key] = page
            self.retain(page)
            pages.append(page)
            payloads.append(self._payload.get(key))
        if want_payloads:
            return len(pages) * self.page_size, pages, payloads
        return len(pages) * self.page_size, pages

    def register_prefix(self, tokens, page_ids: list[int], payloads=None, shift: int = 0):
        """Publish a prefilled prompt's full pages for reuse (one cache
        reference each; chains already cached are left alone). A
        shift-keyed pool also indexes each page under its chain without the
        shift tail, for `match_cow`."""
        keys = self._chain_keys(tokens, shift)
        for i, (key, page) in enumerate(zip(keys, page_ids)):
            if key in self._cache:
                continue
            self._cache[key] = page
            self._cache_of_page[page] = key
            if payloads is not None and i < len(payloads) and payloads[i] is not None:
                self._payload[key] = payloads[i]
            if shift and key[:-shift] not in self._cow:
                self._cow[key[:-shift]] = page
                self._cow_of_page[page] = key[:-shift]
            self.retain(page)

    def match_cow(self, tokens, page_idx: int):
        """A page whose first page_size-token span matches page `page_idx`
        of `tokens` ignoring the shift tail, retained for the caller (copy
        it, then release), or None. Its shift-dependent final row is stale
        for the caller's chain and stays untagged until rewritten."""
        key = tuple(int(t) for t in tokens[: (page_idx + 1) * self.page_size])
        if len(key) < (page_idx + 1) * self.page_size:
            return None
        page = self._cow.get(key)
        if page is None:
            return None
        self.retain(page)
        return page


def _pool_tensors(kv: PagedKVCache):
    return [t for t in (kv.k, kv.v, kv.k_scale, kv.v_scale) if t is not None]


def copy_pool_page(kv: PagedKVCache, src: int, dst: int) -> PagedKVCache:
    """Copy physical page `src` to `dst` across every layer, in place (the
    copy-on-write primitive)."""
    for t in _pool_tensors(kv):
        t[:, dst].copy_(t[:, src])
    return kv


def copy_pool_pages(kv: PagedKVCache, srcs, dsts) -> PagedKVCache:
    """copy_pool_page for each (src, dst) pair, in order and in place; the
    pairs are host ints, so nothing is padded or dropped (the reference pads
    its scatter with an out-of-range dst that the scatter drops)."""
    for a, b in zip(srcs, dsts):
        copy_pool_page(kv, int(a), int(b))
    return kv


def gather_pages(pool: torch.Tensor, li: int, page_table: torch.Tensor,
                 n_pages: int) -> torch.Tensor:
    """Layer li of pool [L, P, H, page, D] (or [L, P, H, page] for int8
    scales) -> per-row contiguous view [B, H, n_pages*page, ...]. Unmapped
    (-1) pages read page 0, explicitly (their rows stay invisible through
    the tags)."""
    pt = page_table[:, :n_pages].clamp(min=0).long()  # [B, NP]
    g = pool[li][pt]  # [B, NP, H, page, ...]
    b, np_, h, ps = g.shape[:4]
    perm = (0, 2, 1, 3) + tuple(range(4, g.dim()))
    return g.permute(perm).reshape(b, h, np_ * ps, *g.shape[4:])
