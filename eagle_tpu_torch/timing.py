"""Time of kernels on the card (no JAX counterpart: the reference timed
slopes over a scan through its relay).

`device_ms` captures the calls into a CUDA graph once and times a replay of
the graph between two CUDA events, so the host's launch overhead (Python
wrappers, ctypes) does not count and every launch is counted: the events
bracket the whole replay. A torch.profiler trace of the same calls, which
this module used before, now and then held the events of only some calls
(on an H100 with torch 2.11: one of five calls at 512 rows, which read as a
5x faster kernel), or none. The replay's time includes the gaps between the
graph's kernels, about a microsecond each."""

from __future__ import annotations

import torch


def device_us(event) -> float:
    """Device time (us) of one torch.profiler key_averages() entry that ran
    on the card (a kernel, copy or fill); 0 for host-side operators, whose
    self device time repeats their kernels' time."""
    from torch.autograd import DeviceType

    if event.device_type != DeviceType.CUDA:
        return 0.0
    dev = getattr(event, "self_device_time_total", None)
    return dev if dev is not None else getattr(event, "self_cuda_time_total", 0)


def device_ms(fn, reps: int, warmup: int = 2) -> float:
    """Time per call on the card of `fn(i)` for i = 0 .. reps-1: the calls
    are captured into one CUDA graph after `warmup` calls, and the graph's
    second replay is timed with CUDA events. `fn` must not synchronize with
    the host (graph capture refuses it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the default stream, as capture wants
        for i in range(warmup):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i)
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps
    del graph
    return ms
