"""One dispatch per decode step or group of speculative cycles: CUDA graphs
of the engines' in-place bodies (no JAX counterpart: it is what `jax.jit`
of the reference's scanned `_decode_chunk` and `_multi_cycle` does).

A body is a Python function that reads and writes only static device
tensors (the cache, the engine's carried state, its output buffers), so a
graph captured once replays it on the same addresses. `StepGraphs.run`:

- the first call for a key runs the body eagerly on a side stream, as
  `timing.py:device_ms` warms up: a real step, since it writes K/V rows,
  tags and the carried state. Then it captures the body into the engine's
  one graph pool; capture records the launches and runs nothing.
- every later call replays the graph on the current stream.

A graph is keyed on the caller's static key (the attention-read bucket,
the number of cycles), on `fused_ffn_mode()` (the forward reads it while
it is captured) and on the `data_ptr()` of the tensors the body touches
(the ctypes launches bake those pointers in): a replaced cache recaptures.
The weights' pointers are baked in too; an engine's parameters are fixed
for its life.

`_build.launches` counts replays: the counts the wrappers add while the
body is captured are taken back out (capture is not execution) and added
once per replay, so a replayed step counts as an eager one does.

There is no fallback: a failed capture or replay raises. With `enabled`
False (the caller's `cuda_graphs=False`, or a CPU device, where graphs do
not apply) every call runs the body eagerly."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Hashable, Sequence

import torch

from .. import _build
from ..models.llama import fused_ffn_mode


def _add(counts: dict[str, int], sign: int) -> None:
    for k, v in counts.items():
        _build.launches[k] += sign * v


@dataclasses.dataclass
class _Graph:
    ptrs: tuple[int, ...]
    graph: Any  # torch.cuda.CUDAGraph
    counts: dict[str, int]  # the launches of one replay


class StepGraphs:
    """The CUDA graphs of one engine, sharing one memory pool. Counters:
    `eager` bodies run eagerly (warm-ups, or every body when disabled),
    `captures` and `replays`."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.eager = 0
        self.captures = 0
        self.replays = 0
        self._pool = None
        self._graphs: dict[Hashable, _Graph] = {}

    def run(self, key: Hashable, body: Callable[[], None],
            tensors: Sequence[torch.Tensor]) -> None:
        """Run `body` once: eagerly, or as a replay of its graph for `key`."""
        if not self.enabled:
            body()
            self.eager += 1
            return
        full_key = (key, fused_ffn_mode())
        ptrs = tuple(t.data_ptr() for t in tensors)
        entry = self._graphs.get(full_key)
        if entry is not None and entry.ptrs == ptrs:
            entry.graph.replay()
            _add(entry.counts, 1)
            self.replays += 1
            return
        self._graphs.pop(full_key, None)  # a graph on replaced tensors is stale
        self._warm_up(body)  # the real step
        self.eager += 1
        before = dict(_build.launches)
        graph = self._capture(body)
        counts = {k: v - before[k] for k, v in _build.launches.items() if v != before[k]}
        _add(counts, -1)  # capture is not execution
        self._graphs[full_key] = _Graph(ptrs, graph, counts)
        self.captures += 1

    def _warm_up(self, body: Callable[[], None]) -> None:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream().wait_stream(side)

    def _capture(self, body: Callable[[], None]):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool):
            body()
        return graph
