"""Continuous batching over a shared KV page pool (port of
eagle_tpu/runtime/paged_batcher.py: `_flush_rows` and `PagedBatcher` with
`_ensure_writable`, `_quarantine`, `_flush_admissions`, prefix-hit
admission in `submit`, the scheduler's five hooks, and `save_slot` /
`restore_slot` through the per-sequence format).

Many slots draw cache memory from one pool of pages per cache (target and
draft), so their summed context can exceed what a dense B x max_seq cache
would hold, and prompts that share full pages of a prefix share the pages
and skip their prefill.

- device: the engine's state becomes two `PagedKVCache` pools
  (`EagleChainEngine.fresh_paged_state`); the forward writes and reads
  through each row's page table, so the chunk, the cycle and the rollback
  are the dense batcher's, graphs included.
- host: `PagePool` allocators own the free lists, refcounts and the
  full-page prefix cache. The batcher maps each slot's write windows just
  before they are written, copies a shared page before a slot writes into
  it, registers a finished prompt's full pages, and admits a new prompt on
  its longest cached prefix.

The page tables are authoritative on the host and copied into the same
device tensors when they change, so the cycle's graphs replay. An
admission's device effects (copy-on-write copies, table sync, the row's
preset tags and feature, and parking rows at max_seq) are deferred and
applied at the next step, before any device work, in their order.

EAGLE specifics: the draft row at position p holds (x_{p+1}, f_p), so draft
pages are keyed with one token more (shift=1), and each target page carries
the feature of its last position as its payload: a matched prefix seeds the
draft head without running the target over it.

Two faults of the reference are not copied: `save_slot` and `restore_slot`
apply the pending admissions first, and `_on_slot_freed` cancels the slot's
pending admissions and copy-on-write copies."""

from __future__ import annotations

import numpy as np
import torch

from .paged_kv import PagePool, copy_pool_page, copy_pool_pages
from .scheduler import ContinuousBatcher, Slot
from .speculative import EagleChainEngine, SpecState


def _flush_rows(state: SpecState, max_seq: int, q_sids, a_sids, rows_t, rows_d,
                feats) -> SpecState:
    """Apply a step's deferred quarantines and admissions, in place: rows
    `q_sids` park at n_past = max_seq (their cycle writes go to the scratch
    page), then each admitted row `a_sids[i]` takes its tag rows `rows_t[i]`
    / `rows_d[i]` (host arrays) and boundary feature `feats[i]`, in order.
    The indices are host ints, so nothing is padded: the reference pads its
    scatters with an out-of-range index that they drop, which `index_put_`
    on CUDA asserts on."""
    dev = state.n_past.device
    if len(q_sids):
        state.n_past[torch.as_tensor(list(q_sids), dtype=torch.long, device=dev)] = max_seq
    for sid, rt, rd, f in zip(a_sids, rows_t, rows_d, feats):
        for kv, row in ((state.tgt_kv, rt), (state.dft_kv, rd)):
            tags = torch.full((kv.slot_pos.shape[1],), -1, dtype=torch.int32)
            tags[:len(row)] = torch.from_numpy(np.asarray(row, np.int32))
            kv.slot_pos[sid].copy_(tags)
        state.feature[sid].copy_(f)
    return state


class PagedBatcher(ContinuousBatcher):
    """ContinuousBatcher whose KV memory is a shared page pool: `n_pages`
    target pages (and `dft_n_pages` draft pages, by default as many) for
    all `engine.batch` slots, each of which may still address max_seq
    positions. Pages are allocated for the regions written. MemoryError
    when every page is held by a live slot."""

    def __init__(self, engine: EagleChainEngine, n_pages: int, page_size: int = 64,
                 prefill_chunk: int | None = None, dft_n_pages: int | None = None,
                 prefix_cache: bool = True):
        # chunks return the feature at every page boundary, so reuse stays
        # page-granular at any chunk size that is a whole number of pages
        prefill_chunk = page_size if prefill_chunk is None else prefill_chunk
        assert prefill_chunk % page_size == 0, (prefill_chunk, page_size)
        self._pool_shape = (n_pages, page_size, dft_n_pages)
        super().__init__(engine, prefill_chunk=prefill_chunk)
        self.ps = page_size
        self._feat_every = page_size
        self.prefix_cache = prefix_cache
        #: deferred device work, applied in order at the next step()
        self._pending_quar: list[int] = []
        self._pending_admits: list[tuple] = []  # (sid, row_t, row_d, feature)
        self._pending_copies: dict[str, list[tuple[int, int, int]]] = {
            "tgt": [], "dft": []}  # (sid, src, dst)
        self.pools = {"tgt": PagePool(n_pages, page_size),
                      "dft": PagePool(dft_n_pages or n_pages, page_size)}
        mp = self.state.tgt_kv.page_table.shape[1]
        #: host-authoritative page tables; the device copies sync on change
        self.tables = {"tgt": np.full((self.batch, mp), -1, np.int32),
                       "dft": np.full((self.batch, mp), -1, np.int32)}
        self._dirty = {"tgt": False, "dft": False}
        #: page-boundary features of each prefilling slot {page index: [D]}
        self._payloads: dict[int, dict] = {}
        self.stats = {"prefill_tokens_skipped": 0, "pages_copied": 0, "prefix_hits": 0}

    def _fresh_state(self):
        """The engine's state, made paged: pools of this batcher's shape."""
        return self.engine.fresh_paged_state(*self._pool_shape)

    # -- pool plumbing -----------------------------------------------------

    def _kv(self, kind):
        return self.state.tgt_kv if kind == "tgt" else self.state.dft_kv

    def _sync_tables(self):
        for kind in ("tgt", "dft"):
            if self._dirty[kind]:
                self._kv(kind).page_table.copy_(torch.from_numpy(self.tables[kind]))
                self._dirty[kind] = False

    def pages_in_use(self) -> dict[str, int]:
        """Pool pages held (by a slot or the prefix cache), per cache."""
        return {k: p.n_pages - len(p.free) for k, p in self.pools.items()}

    def _ensure_writable(self, kind: str, slot_id: int, lo: int, hi: int):
        """Map every page covering positions [lo, hi) to a page this slot
        may write: allocate unmapped pages, copy shared ones first."""
        if hi <= lo:
            return
        pool, table = self.pools[kind], self.tables[kind]
        last = min((hi - 1) // self.ps, table.shape[1] - 1)
        for pg in range(max(lo, 0) // self.ps, last + 1):
            cur = int(table[slot_id, pg])
            if cur < 0:
                table[slot_id, pg] = pool.alloc()
                self._dirty[kind] = True
            elif pool.is_shared(cur):
                new = pool.alloc()
                copy_pool_page(self._kv(kind), cur, new)
                table[slot_id, pg] = new
                pool.release(cur)
                self._dirty[kind] = True
                self.stats["pages_copied"] += 1

    def _quarantine(self, sid: int):
        """Park row `sid` at n_past = max_seq at the next flush: a masked
        cycle still writes an inactive row's K/V data (not its tags), and
        at max_seq its windows resolve past the table, to the scratch
        page, never into pages it may share."""
        self._pending_quar.append(sid)
        self.n_past[sid] = self.engine.max_seq

    def _flush_admissions(self):
        """Apply every deferred admission effect, in order: copy-on-write
        copies, the table sync, then `_flush_rows`."""
        for kind in ("tgt", "dft"):
            lst = self._pending_copies[kind]
            if lst:
                copy_pool_pages(self._kv(kind), [s for _, s, _ in lst], [d for _, _, d in lst])
                lst.clear()
        self._sync_tables()
        if not (self._pending_quar or self._pending_admits):
            return
        adm = self._pending_admits
        _flush_rows(self.state, self.engine.max_seq, list(dict.fromkeys(self._pending_quar)),
                    [a[0] for a in adm], [a[1] for a in adm], [a[2] for a in adm],
                    [a[3] for a in adm])
        self._pending_quar.clear()
        self._pending_admits.clear()

    def step(self):
        self._flush_admissions()
        super().step()

    # -- admission: prefix matching ----------------------------------------

    def submit(self, prompt_tokens, **kw) -> Slot | None:
        slot = super().submit(prompt_tokens, **kw)
        if slot is None:
            return slot
        self._quarantine(slot.id)
        if not self.prefix_cache:
            return slot
        toks = [int(t) for t in slot.prompt]
        n = len(toks)
        _, pages_t, payloads = self.pools["tgt"].match_prefix(toks, want_payloads=True)
        _, pages_d = self.pools["dft"].match_prefix(toks, shift=1)
        # the draft page at the shared / suffix boundary depends on one
        # suffix token: extend the draft's match by one page through a copy
        # of a page that agrees on its page_size prefix tokens; its final
        # row stays untagged (d_row below) until the resumed prefill's first
        # chunk rewrites it
        if len(pages_d) < len(pages_t):
            src = self.pools["dft"].match_cow(toks, len(pages_d))
            if src is not None:
                try:
                    fresh = self.pools["dft"].alloc()
                except MemoryError:
                    fresh = None
                if fresh is not None:
                    self._pending_copies["dft"].append((slot.id, src, fresh))
                    pages_d.append(fresh)
                    self.stats["pages_copied"] += 1
                self.pools["dft"].release(src)
        # the shared length: both caches cover it, >= 1 token of real
        # prefill remains, and the boundary feature f_{s-1} is known
        m = min(len(pages_t), len(pages_d))
        while m > 0 and (m * self.ps >= n or payloads[m - 1] is None):
            m -= 1
        for p in pages_t[m:]:
            self.pools["tgt"].release(p)
        dropped = set(pages_d[m:])
        for p in pages_d[m:]:
            self.pools["dft"].release(p)
        if dropped:  # a copy into a page given back is no copy to make
            self._pending_copies["dft"] = [c for c in self._pending_copies["dft"]
                                           if not (c[0] == slot.id and c[2] in dropped)]
        if m == 0:
            return slot
        s = m * self.ps
        sid = slot.id
        self.tables["tgt"][sid, :m] = pages_t[:m]
        self.tables["dft"][sid, :m] = pages_d[:m]
        self._dirty["tgt"] = self._dirty["dft"] = True
        # the row's state as if positions [0, s) were prefilled: the tags
        # show the shared pages, the payload is the boundary feature
        self._pending_admits.append((sid, np.arange(s, dtype=np.int32),
                                     np.arange(s - 1, dtype=np.int32), payloads[m - 1]))
        slot.consumed = s
        self.stats["prefill_tokens_skipped"] += s
        self.stats["prefix_hits"] += 1
        return slot

    # -- scheduler hooks ---------------------------------------------------

    def _before_prefill_chunk(self, slot: Slot, n: int):
        c = slot.consumed
        self._ensure_writable("tgt", slot.id, c, c + n)
        # draft pairs for tokens [c, c+n) sit at draft positions [c-1, c+n-1)
        self._ensure_writable("dft", slot.id, max(c - 1, 0), c + n - 1)
        self._sync_tables()

    def _after_prefill_chunk(self, slot: Slot, finished: bool):
        if not self.prefix_cache:
            return
        # each page the chunk filled gets its boundary feature: row m of the
        # chunk's features is that of position start + (m+1)*page - 1
        start, bf = self._chunk_feats
        assert start % self.ps == 0, start
        pl = self._payloads.setdefault(slot.id, {})
        for m in range((slot.consumed - start) // self.ps):
            pl[start // self.ps + m] = bf[m]
        if finished:
            self._register_prompt(slot)

    def _register_prompt(self, slot: Slot):
        toks = [int(t) for t in slot.prompt]
        n = len(toks)
        full_t = n // self.ps
        if full_t:
            pages = [int(self.tables["tgt"][slot.id, i]) for i in range(full_t)]
            pl = self._payloads.get(slot.id, {})
            self.pools["tgt"].register_prefix(toks, pages,
                                              payloads=[pl.get(i) for i in range(full_t)])
        # draft page i is full iff rows [i*page, (i+1)*page) were all
        # written: the prompt's last draft row is position n-2
        full_d = (n - 1) // self.ps
        if full_d:
            pages = [int(self.tables["dft"][slot.id, i]) for i in range(full_d)]
            self.pools["dft"].register_prefix(toks, pages, shift=1)
        self._payloads.pop(slot.id, None)

    def _before_cycle(self, n_past: np.ndarray):
        k = self.engine.K
        for slot in self.slots:
            if slot.state != "generating" or not self._active_mask[slot.id]:
                continue
            m = int(n_past[slot.id])
            # verify writes [m, m+K+1); draft writes [m-1, m+K)
            self._ensure_writable("tgt", slot.id, m, m + k + 1)
            self._ensure_writable("dft", slot.id, max(m - 1, 0), m + k)
        self._sync_tables()

    def _on_slot_freed(self, slot: Slot):
        sid = slot.id
        for kind in ("tgt", "dft"):
            table, pool = self.tables[kind], self.pools[kind]
            for pg in np.nonzero(table[sid] >= 0)[0]:
                pool.release(int(table[sid, pg]))
            table[sid] = -1
            self._dirty[kind] = True
            # the slot's pending copies target pages it just gave back
            self._pending_copies[kind] = [c for c in self._pending_copies[kind] if c[0] != sid]
        self._pending_admits = [a for a in self._pending_admits if a[0] != sid]
        self._quarantine(sid)
        self._payloads.pop(sid, None)

    # -- slot save / restore -----------------------------------------------
    # A paged row is a view into the shared pool, so a slot saves through
    # the dense per-sequence format: its mapped pages gathered into dense
    # rows, the file the dense batcher writes and reads.

    def save_slot(self, slot_id: int, path) -> dict:
        slot = self.slots[slot_id]
        if slot.state == "free":
            raise ValueError("a paged slot is saved while it is live: a finished request's "
                             "pages went back to the shared pool (the dense batcher can save "
                             "after completion, its rows being its own)")
        self._flush_admissions()
        return super().save_slot(slot_id, path)

    def _restore_into(self, slot_id: int, path) -> dict:
        from .state_io import insert_seq_state, read_seq_state

        self._flush_admissions()  # what is pending lands before the restored rows
        sub, extra = read_seq_state(path, self.engine.device)
        for kind, row in (("tgt", sub.tgt_kv), ("dft", sub.dft_kv)):
            self._ensure_writable(kind, slot_id, 0, row.k.shape[3])
        self._sync_tables()
        insert_seq_state(self.state, sub, slot_id)
        return extra
