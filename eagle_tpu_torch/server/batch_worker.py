"""The inference thread that drives the ContinuousBatcher (port of
eagle_tpu/server/batch_worker.py: `BatchRequest` and `BatcherWorker` with
admission, aborts, deadlines, `call` and `shutdown`).

All device work stays on this one thread; the HTTP handlers talk to it
through thread-safe queues, the reference server's inference-thread / HTTP-
thread split.

No fault is swallowed. A request the batcher refuses (a prompt that does
not fit a slot, a sampler not ported) gets its `on_error`. An exception
from a step reaches every live and pending request's `on_error`, ends the
thread, and every later request gets it too: `error` holds it."""

from __future__ import annotations

import concurrent.futures
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable


@dataclass
class BatchRequest:
    prompt_ids: list
    max_new: int
    on_token: Callable  # called from the worker thread per token
    on_done: Callable  # called once with the slot's final token list
    stop_at_eos: bool = True
    sampler: Any = None  # per-request SamplerConfig (slot row of BatchedSamplerParams)
    spec_k: Any = None  # per-request speculative accept cap
    request_id: str | None = None
    timeout_s: float | None = None  # wall-clock abort deadline
    submitted: float = field(default_factory=time.time)
    on_error: Callable | None = None  # called once with the exception that ended it


def _fail(req: BatchRequest, err: BaseException) -> None:
    if req.on_error is None:
        raise err
    req.on_error(err)


class BatcherWorker(threading.Thread):
    def __init__(self, batcher):
        super().__init__(daemon=True, name="eagle-tpu-torch-batcher")
        self.batcher = batcher
        self.requests: queue.Queue[BatchRequest] = queue.Queue()
        self._aborts: queue.Queue[str] = queue.Queue()
        self._ops: queue.Queue = queue.Queue()
        self._halt = threading.Event()
        self._wake = threading.Event()
        self.error: BaseException | None = None  # the step fault that ended the thread

    def submit(self, req: BatchRequest):
        self.requests.put(req)
        self._wake.set()
        if self.error is not None:  # the thread has ended (`run` sets it before draining)
            for r in self._drain(self.requests):
                _fail(r, self.error)

    def abort(self, request_id: str):
        """Request cancellation (slot release)."""
        self._aborts.put(request_id)
        self._wake.set()

    def call(self, fn):
        """Run `fn(batcher)` on the worker thread between steps; returns a
        concurrent future."""
        fut: concurrent.futures.Future = concurrent.futures.Future()
        self._ops.put((fut, fn))
        self._wake.set()
        return fut

    def shutdown(self):
        self._halt.set()
        self._wake.set()

    def _drain(self, q: queue.Queue) -> list:
        out = []
        while True:
            try:
                out.append(q.get_nowait())
            except queue.Empty:
                return out

    def run(self):
        pending: list[BatchRequest] = []
        live: dict[int, BatchRequest] = {}  # slot id -> request
        try:
            while not self._halt.is_set():
                self._tick(pending, live)
        except BaseException as e:  # a step fault: every waiting request gets it
            self.error = e
            for req in [*live.values(), *pending, *self._drain(self.requests)]:
                _fail(req, e)
            for fut, _ in self._drain(self._ops):
                fut.set_exception(e)

    def _tick(self, pending: list[BatchRequest], live: dict[int, BatchRequest]) -> None:
        b = self.batcher
        # admit pending requests into free slots
        pending.extend(self._drain(self.requests))
        while pending:
            req = pending[0]
            try:
                slot = b.submit(req.prompt_ids, max_new_tokens=req.max_new,
                                on_token=req.on_token, stop_at_eos=req.stop_at_eos,
                                sampler=req.sampler, spec_k=req.spec_k,
                                request_id=req.request_id)
            except (ValueError, NotImplementedError) as e:  # this request's fault only
                pending.pop(0)
                _fail(req, e)
                continue
            if slot is None:
                break  # saturated; retry after a step frees slots
            pending.pop(0)
            live[slot.id] = req

        # aborts + deadlines (a wedged generation must not pin the worker)
        for rid in self._drain(self._aborts):
            for sid, req in list(live.items()):
                if req.request_id == rid:
                    b.abort(rid)
                    live.pop(sid).on_done(b.slots[sid].generated)
            pending[:] = [r for r in pending if r.request_id != rid]
        now = time.time()
        for sid, req in list(live.items()):
            if req.timeout_s is not None and now - req.submitted > req.timeout_s:
                b._free(b.slots[sid])
                live.pop(sid).on_done(b.slots[sid].generated)

        # serialized stateful ops
        for fut, fn in self._drain(self._ops):
            try:
                fut.set_result(fn(b))
            except Exception as e:  # surface to the caller
                fut.set_exception(e)
            # a slot an op freed or restored over is no longer its request's
            for sid in list(live):
                if b.slots[sid].state in ("free", "restored"):
                    live.pop(sid).on_done(b.slots[sid].generated)

        if b.n_active > 0 or b.n_pending > 0:
            b.step()
            for sid in list(live):
                if b.slots[sid].state == "free":
                    live.pop(sid).on_done(b.slots[sid].generated)
        else:
            self._wake.wait(timeout=0.05)
            self._wake.clear()
