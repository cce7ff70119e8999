"""Device-true times on the CUDA card: what the card itself takes for a call,
without the host's launch overhead (counterpart of the root ``bench.py``'s
scan protocol, ``bench.py:179-262``, of ``eventad_tpu/utils/jaxtools.
trace_device_ms`` and of the dispatch floor in ``eventad_tpu/streaming/
evaluate.py:267-276``).

- :func:`graph_device_ms` (:func:`capture`, then :func:`replay_ms`): the
  call captured once in a CUDA graph, the graph replayed ``n1`` and ``n2``
  times; the two lengths' difference per replay cancels the host's round
  trip, as the JAX bench's two scan lengths do.  A replay reruns every
  captured kernel on the same buffers, so no stage can be hoisted out of
  the loop and no input needs the ``dynamic_zero_perturb`` that the JAX
  scan body applies.  A capture's own time can differ from another
  capture's of the same call (``tools/replay_probe.py``): compare times
  of one capture.
- :func:`trace_device_ms`: the union of the device intervals (kernels,
  copies, memsets) of each call in a ``torch.profiler`` trace.  Traces
  taken late in a process lose device events (``PERF.md`` §6, PRs 1-12:
  a trace has to be its process's first): the function counts the device
  events of each call and raises when the calls disagree, and callers take
  this trace early in the process.
- :func:`dispatch_floor_ms`: the per-dispatch time of a scalar add, 50
  enqueued and one synchronise.

All of them need the card and raise on the CPU.
"""
from __future__ import annotations

import bisect
import time

import torch

_CALL = "devtime.call"
DISPATCH_CALLS = 50


def _require_card(what: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what}: no CUDA device; device times are "
                           f"measured on the card only")


def capture(fn, warmup: int = 3):
    """``(graph, out)``: ``fn()`` run ``warmup`` times on a side stream (the
    ``torch.cuda.graph`` recipe: lazy initialisation and cached tables
    happen there), then captured once into a ``torch.cuda.CUDAGraph``;
    ``out`` is the captured call's output, which every replay rewrites in
    place.  A host synchronisation or a copy to the card inside ``fn``
    makes the capture raise."""
    _require_card("capture")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    torch.cuda.synchronize()
    return graph, out


def replay_ms(graph, n1: int = 10, n2: int = 50, reps: int = 4) -> float:
    """The card's milliseconds for one replay of a captured ``graph``: the
    graph replayed ``n1`` and then ``n2`` times, each run ending in one
    synchronise, best of ``reps`` each; ``(T(n2) - T(n1)) / (n2 - n1)``."""
    _require_card("replay_ms")

    def wall(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            graph.replay()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    w1 = min(wall(n1) for _ in range(reps))
    w2 = min(wall(n2) for _ in range(reps))
    return (w2 - w1) / (n2 - n1) * 1e3


def graph_device_ms(fn, n1: int = 10, n2: int = 50, reps: int = 4):
    """``(ms, out)``: the card's milliseconds for one call of ``fn`` and the
    captured call's output; ``fn`` is captured (:func:`capture`) and timed
    by :func:`replay_ms`."""
    _require_card("graph_device_ms")
    graph, out = capture(fn)
    graph.replay()
    return replay_ms(graph, n1, n2, reps), out


def union_intervals(spans) -> list:
    """The union of ``(start, end)`` intervals: sorted, disjoint
    intervals."""
    out = []
    for lo, hi in sorted(spans):
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def _union_us(spans) -> float:
    return sum(hi - lo for lo, hi in union_intervals(spans))


def trace_device_ms(fn, iters: int = 6) -> float:
    """The card's busy milliseconds per call of ``fn``: ``fn()`` runs
    ``iters`` times under ``torch.profiler``, each call in a range of its
    own and ended by a synchronise; each device event is assigned to the
    call whose range it starts in, and a call's time is the union of its
    events' intervals.  Raises when the calls hold different numbers of
    device events (a trace that lost some) or none."""
    _require_card("trace_device_ms")
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            with record_function(_CALL):
                fn()
                torch.cuda.synchronize()
    events = prof.events()
    starts = sorted(e.time_range.start for e in events
                    if e.name == _CALL
                    and not str(e.device_type).endswith("CUDA"))
    if len(starts) != iters:
        raise RuntimeError(f"trace_device_ms: {len(starts)} call ranges in "
                           f"the trace, {iters} calls made")
    spans = [[] for _ in range(iters)]
    for e in events:
        if not str(e.device_type).endswith("CUDA") \
                or getattr(e, "is_user_annotation", False) or e.name == _CALL:
            continue
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        if i < 0:
            raise RuntimeError(f"trace_device_ms: device event {e.name!r} "
                               f"starts before the first call")
        spans[i].append((e.time_range.start, e.time_range.end))
    counts = [len(s) for s in spans]
    if len(set(counts)) != 1 or counts[0] == 0:
        raise RuntimeError(f"trace_device_ms: device events per call "
                           f"{counts}; a trace that lost events, or none")
    return sum(_union_us(s) for s in spans) / iters / 1e3


def dispatch_floor_ms() -> float:
    """Milliseconds per dispatch of a scalar add on the card:
    ``DISPATCH_CALLS`` enqueued, then one synchronise (after one to warm
    up)."""
    _require_card("dispatch_floor_ms")
    y = torch.zeros((), device="cuda")
    y.add_(1.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DISPATCH_CALLS):
        y.add_(1.0)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / DISPATCH_CALLS * 1e3
