"""Continuous batching over the chain engine's rows (port of
eagle_tpu/runtime/scheduler.py: `Slot` and `ContinuousBatcher` with
`submit`, `abort`, `step`, `run_until_done`, `save_slot`, `restore_slot`,
`resume_slot` and the paged batcher's hooks).

A fixed batch of B slots, each an independent sequence in its own row of
the engine's caches. Prompt prefill is chunked: each step admits at most
one chunk of the head-of-queue prompt (`EagleChainEngine._prefill_chunk`
on the row's views: the port's counterpart of the reference's
`_take_row_kv` / `_put_row_kv`, with nothing copied), then runs one
speculative cycle over every row, masked to the generating slots
(`_multi_cycle(1, active=...)`, one graph replay on the card). Each slot's
sampler and `spec_k` occupy its row of the engine's `BatchedSamplerParams`.

Slot lifecycle, streaming and the stop rules live on the host. The host
mirrors every row's n_past (a chunk sets it, a cycle adds `n_out` to the
generating rows), so a step reads the device once, for the cycle's tokens
and counts. Parked rows sit at n_past = 1 so draft positions stay >= 0.

A slot saves to and restores from a per-sequence state file
(`runtime/state_io.py`): the same file for a dense and a paged batcher, so
either restores what the other saved.

Unlike the reference, `submit` refuses a prompt that leaves no room in a
slot (the reference's cache writes would clamp into its last slots)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from .sampling import SamplerConfig
from .speculative import EagleChainEngine


@dataclass
class Slot:
    id: int
    state: str = "free"  # free | prefilling | generating
    request_id: str | None = None
    prompt_len: int = 0
    max_new: int = 0
    generated: list = field(default_factory=list)
    on_token: Callable | None = None  # streaming callback(token_id)
    eos_id: int = 2
    stop_at_eos: bool = True
    # chunked-prefill progress
    prompt: np.ndarray | None = None
    consumed: int = 0

    @property
    def done(self) -> bool:
        if self.generated and self.stop_at_eos and self.generated[-1] == self.eos_id:
            return True
        return len(self.generated) >= self.max_new


class ContinuousBatcher:
    """Slot scheduler over a batched `EagleChainEngine`."""

    def __init__(self, engine: EagleChainEngine, prefill_chunk: int = 64):
        self.engine = engine
        self.batch = engine.batch
        self.prefill_chunk = prefill_chunk
        self.slots = [Slot(id=i, eos_id=engine.eos_id) for i in range(self.batch)]
        self.state = self._fresh_state()
        self.state.n_past.fill_(1)  # parked
        self.n_past = np.ones(self.batch, np.int64)  # the host's mirror of state.n_past
        self._active_mask = np.zeros(self.batch, bool)
        self._prefill_queue: list[Slot] = []
        #: stride at which prompt chunks also return boundary features (0:
        #: off; the paged batcher sets its page size) and the last chunk's
        #: (start, features [ct // stride, D] on the device), for the hooks
        self._feat_every = 0
        self._chunk_feats: tuple[int, torch.Tensor] | None = None

    def _fresh_state(self):
        """The engine's state, reset for this batcher: dense caches."""
        return self.engine.fresh_dense_state()

    # ------------------------------------------------------------------

    def submit(
        self,
        prompt_tokens,
        max_new_tokens: int = 128,
        request_id: str | None = None,
        on_token: Callable | None = None,
        stop_at_eos: bool = True,
        sampler: SamplerConfig | None = None,
        spec_k: int | None = None,
    ) -> Slot | None:
        """Assign a request to a free slot (None if saturated) and queue its
        prompt for chunked prefill. `sampler` configures the slot's row of
        the engine's per-slot sampler params; `spec_k` caps accepted drafts
        per cycle for this request."""
        prompt = np.asarray(prompt_tokens, np.int32)
        free = [s for s in self.slots if s.state == "free"]
        cap = self.slot_capacity(free[0].id if free else 0)
        if not 0 < len(prompt) < cap:
            raise ValueError(f"a prompt of {len(prompt)} tokens does not fit a slot of {cap}")
        if not free:
            return None
        slot = free[0]
        # always (re)configure the row: a reused slot must not inherit the
        # previous request's sampler when this one carries none (a refused
        # sampler leaves the slot free)
        self.engine.set_row_sampler(
            slot.id, sampler or self.engine.scfg,
            spec_k=spec_k if spec_k is not None else self.engine.K,
        )
        slot.state = "prefilling"
        slot.request_id = request_id
        slot.prompt = prompt
        slot.consumed = 0
        slot.prompt_len = len(prompt)
        slot.max_new = max_new_tokens
        slot.generated = []
        slot.on_token = on_token
        slot.stop_at_eos = stop_at_eos
        self._prefill_queue.append(slot)
        return slot

    def _free(self, slot: Slot) -> None:
        if slot in self._prefill_queue:
            self._prefill_queue.remove(slot)
        slot.state = "free"
        self._active_mask[slot.id] = False
        self._on_slot_freed(slot)

    def abort(self, request_id: str) -> bool:
        """Release the slot serving `request_id` (mid-prefill or
        mid-generation); the row is reclaimed by the next request's
        prefill."""
        for slot in self.slots:
            if slot.request_id == request_id and slot.state != "free":
                self._free(slot)
                slot.prompt = None
                return True
        return False

    def _emit(self, slot: Slot, token: int):
        slot.generated.append(token)
        if slot.on_token:
            slot.on_token(token)

    def _maybe_finish(self, slot: Slot):
        if slot.state == "generating" and slot.done:
            self._free(slot)

    def slot_capacity(self, slot_id: int) -> int:
        """Max cache positions this slot may occupy (paged batchers override)."""
        return self.engine.max_seq

    def _on_slot_freed(self, slot: Slot):
        """Hook for resource reclamation (paged batchers release pages)."""

    @property
    def n_active(self) -> int:
        return int(self._active_mask.sum())

    @property
    def n_pending(self) -> int:
        return len(self._prefill_queue)

    def _before_prefill_chunk(self, slot: Slot, n: int):
        """Hook: about to prefill `n` prompt tokens at slot.consumed (paged
        batchers map the chunk's write-window pages here)."""

    def _after_prefill_chunk(self, slot: Slot, finished: bool):
        """Hook: a chunk landed (paged batchers capture page-boundary
        features here, and register the prompt's pages when `finished`)."""

    def _before_cycle(self, n_past: np.ndarray):
        """Hook: about to run one cycle over all generating slots. `n_past`
        is the host's copy: hooks must not read the device for it."""

    def _advance_prefill(self):
        """Process ONE chunk of the head-of-queue prompt."""
        slot = self._prefill_queue[0]
        prompt = slot.prompt
        ct = self.prefill_chunk
        chunk = np.zeros(ct, np.int32)
        n = min(ct, len(prompt) - slot.consumed)
        chunk[:n] = prompt[slot.consumed: slot.consumed + n]
        self._before_prefill_chunk(slot, n)
        eng = self.engine
        start = slot.consumed
        tokens = torch.from_numpy(chunk).to(eng.device)
        if self._feat_every:
            self._chunk_feats = (start, eng._prefill_chunk(slot.id, tokens, start, len(prompt),
                                                           feat_every=self._feat_every))
        else:
            eng._prefill_chunk(slot.id, tokens, start, len(prompt))
        slot.consumed += n
        self.n_past[slot.id] = slot.consumed
        finished = slot.consumed >= len(prompt)
        self._after_prefill_chunk(slot, finished)
        if finished:
            self._prefill_queue.pop(0)
            slot.state = "generating"
            self._emit(slot, int(self.state.last_token[slot.id]))
            self._active_mask[slot.id] = True
            self._maybe_finish(slot)

    def step(self):
        """One scheduler tick: at most one prefill chunk, then one
        speculative cycle across all generating slots."""
        if self._prefill_queue:
            self._advance_prefill()
        if self.n_active == 0:
            return
        eng = self.engine
        self._before_cycle(self.n_past)
        # attention-read bound: every generating row's tags lie below
        # max(n_past over them) + K + 2 after this cycle
        hint = int(self.n_past[self._active_mask].max()) + eng.K + 2
        res = eng._multi_cycle(1, kv_limit=eng.kv_read_bucket(hint), active=self._active_mask)
        rows = torch.cat([res.tokens[0], res.n_out[0][:, None]], dim=1).tolist()  # one read
        for slot in self.slots:
            if slot.state != "generating":
                continue
            *toks, k = rows[slot.id]
            self.n_past[slot.id] += k
            for tk in toks[:k]:
                self._emit(slot, tk)
                self._maybe_finish(slot)
                if slot.state == "free":
                    break
            # overflow guard: recycle slots whose cache window is exhausted
            if (slot.state == "generating"
                    and self.n_past[slot.id] + eng.K + 2 >= self.slot_capacity(slot.id)):
                self._free(slot)

    # -- per-slot state save / restore (server.cpp:3690, 3760) ----------

    def _slot_extra(self, slot: Slot) -> dict:
        return {"generated": list(slot.generated), "prompt_len": slot.prompt_len,
                "max_new": slot.max_new, "stop_at_eos": slot.stop_at_eos}

    def save_slot(self, slot_id: int, path) -> dict:
        """Write one slot's sequence state (its cache rows, counters and
        feature) and its host-side progress to `path`; returns the saved
        progress."""
        from .state_io import save_seq_state

        extra = self._slot_extra(self.slots[slot_id])
        save_seq_state(self.state, slot_id, path, extra=extra)
        return extra

    def _restore_into(self, slot_id: int, path) -> dict:
        from .state_io import load_seq_state

        return load_seq_state(self.state, slot_id, path)[1]

    def restore_slot(self, path, slot_id: int | None = None):
        """Load a saved sequence into a free slot (by default the first),
        paused until `resume_slot`. Returns the Slot, or None when no slot
        is free."""
        if slot_id is None:
            free = [s for s in self.slots if s.state == "free"]
            if not free:
                return None
            slot_id = free[0].id
        slot = self.slots[slot_id]
        if slot.state != "free":
            self._free(slot)
        extra = self._restore_into(slot_id, path)
        self.n_past[slot_id] = int(self.state.n_past[slot_id])
        slot.state = "restored"
        slot.request_id = None
        slot.prompt = None
        slot.generated = list(extra.get("generated", []))
        slot.prompt_len = int(extra.get("prompt_len", 0))
        slot.max_new = int(extra.get("max_new", 0))
        slot.stop_at_eos = bool(extra.get("stop_at_eos", True))
        return slot

    def resume_slot(self, slot_id: int, max_new_tokens: int | None = None,
                    on_token: Callable | None = None, sampler: SamplerConfig | None = None):
        """Continue generating on a restored slot."""
        slot = self.slots[slot_id]
        if slot.state != "restored":
            raise ValueError(f"slot {slot_id} is {slot.state}, not restored")
        if max_new_tokens is not None:
            slot.max_new = max_new_tokens
        slot.on_token = on_token
        self.engine.set_row_sampler(slot_id, sampler or self.engine.scfg, spec_k=self.engine.K)
        slot.state = "generating"
        self._active_mask[slot_id] = True
        return slot

    def run_until_done(self, max_steps: int = 10_000):
        steps = 0
        while (self.n_active > 0 or self._prefill_queue) and steps < max_steps:
            self.step()
            steps += 1
