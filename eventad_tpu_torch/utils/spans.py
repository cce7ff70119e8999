"""The program's spans and counters, recorded while a ``torch.profiler``
session records and free otherwise.

``span(name)`` marks a stage of the program (``with span("model/graph"):``).
With no session recording it returns one shared null context: the cost is
one check of the flag ``torch.profiler`` sets for the whole process while a
session records (``torch.autograd.profiler._is_profiler_enabled``); no
``record_function``, no clock read, no allocation.  While a session records,
the span opens ``record_function("eventad/" + name)``, so that it sits in
the session's trace beside the device operations, on their clock, and it is
tallied here: calls, total host milliseconds and self milliseconds (total
less the spans opened inside it), by name and parent.  Each thread keeps its
own parent stack, so the ``Loader``'s producer thread nests its own spans.
A top-level span carries a unit id that its children share: the number of
units (``model/forward`` or ``stream/step``, the program's batch and chunk)
begun before it, so that the data spans of a batch carry that batch's
index.

``count(name, n)`` adds to a counter, gated the same way.  Besides, while
spans are open under a session, the interval from the first top-level
span's start to the last one's end (on any thread) takes the deltas of the
caching allocator's ``device_mallocs``, ``device_frees`` (a device free
waits for the card) and ``allocator_syncs``, and of the hand-written
kernels' launch counters (the wrappers' ``.launches``, as
``launches/<kernel>``).  A garbage collection is the span ``runtime/gc``
under the span it interrupted, opened and closed from ``gc.callbacks``, and
counts ``gc/gen<N>``; the callback is registered when the first span opens
under a session and taken out by ``reset()``.

``summary()`` exports the tallies; ``reset()`` clears them.  A profiler
session covers the whole process, so one recorder serves it.
"""
from __future__ import annotations

import gc
import sys
import threading
from time import perf_counter_ns

import torch
import torch.autograd.profiler as _profiler

PREFIX = "eventad/"
UNITS = ("model/forward", "stream/step")
GC = "runtime/gc"
# the hand-written kernels' wrappers whose ``.launches`` the counters read:
# kernel -> (module, function)
KERNELS = {
    "K1": ("eventad_tpu_torch.ops.event_graph", "build_graph_cuda"),
    "K2": ("eventad_tpu_torch.ops.spline_fused", "fused_two_block_cuda"),
    "K3": ("eventad_tpu_torch.ops.spline_shift", "shift_spline_conv_cuda"),
    "K4": ("eventad_tpu_torch.ops.upsample_flat", "upsample_rows_cuda"),
    "K5": ("eventad_tpu_torch.ops.spline_fused", "fused_spline_conv_cuda"),
    "K6a": ("eventad_tpu_torch.ops.gather_window",
            "gather_window_rows_cuda"),
    "K6b": ("eventad_tpu_torch.ops.gather_window",
            "scatter_window_rows_cuda"),
    "K7": ("eventad_tpu_torch.ops.bilinear_sample", "sample_bilinear_cuda"),
    "K8": ("eventad_tpu_torch.ops.pooling", "pool_graph_cuda"),
    "K9": ("eventad_tpu_torch.ops.nms", "postprocess_cuda"),
}
# the caching allocator's statistics behind the device counters
ALLOCATOR = {"device_mallocs": "num_device_alloc",
             "device_frees": "num_device_free",
             "allocator_syncs": "num_sync_all_streams"}


def recording() -> bool:
    """Whether a ``torch.profiler`` session records (in any thread)."""
    return _profiler._is_profiler_enabled


class _Null:
    """The span of a process no session records: does nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


NULL = _Null()


def _counter_snapshot() -> dict:
    """The device counters' current values: the allocator's statistics
    (once the card is initialised) and the wrappers' launches."""
    out = {}
    if torch.cuda.is_initialized():
        # the nested form: the flat ``memory_stats()`` also flattens and
        # sorts every statistic in Python, at every top-level span
        stats = torch.cuda.memory_stats_as_nested_dict()
        out = {k: stats.get(s, 0) for k, s in ALLOCATOR.items()}
    for k, (mod, fn) in KERNELS.items():
        m = sys.modules.get(mod)
        if m is not None:
            out["launches/" + k] = getattr(getattr(m, fn), "launches", 0)
    return out


class Recorder:
    """The tallies of the spans and counters recorded so far."""

    def __init__(self):
        # re-entrant: a collection can start inside a locked section, and
        # its callback tallies the ``runtime/gc`` span on the same thread
        self._lock = threading.RLock()
        self._local = threading.local()
        self.clear()

    def clear(self) -> None:
        with self._lock:
            # (name, parent) -> [calls, total ns, self ns, unit ids]
            self.spans = {}
            self.counters = {}
            self.units = 0
            self._open_top = 0
            self._snapshot = None
            self.gc_hooked = False

    def stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def add(self, name: str, n) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def top_opened(self, name: str) -> int:
        """A top-level span opens: its unit id; the device counters'
        interval starts with the first top-level span open."""
        with self._lock:
            unit = self.units
            if name in UNITS:
                self.units += 1
            self._open_top += 1
            first = self._open_top == 1
        if first and name != GC:
            snap = _counter_snapshot()
            with self._lock:
                self._snapshot = snap
        return unit

    def top_closed(self) -> None:
        with self._lock:
            self._open_top = max(self._open_top - 1, 0)
            last = self._open_top == 0
            before, self._snapshot = ((self._snapshot, None) if last
                                      else (None, self._snapshot))
        if before is None:
            return
        after = _counter_snapshot()
        with self._lock:
            for k, v in after.items():
                d = v - before.get(k, 0)
                if d:
                    self.counters[k] = self.counters.get(k, 0) + d

    def tally(self, name, parent, unit, total_ns, self_ns) -> None:
        with self._lock:
            t = self.spans.get((name, parent))
            if t is None:
                t = self.spans[(name, parent)] = [0, 0, 0, set()]
            t[0] += 1
            t[1] += total_ns
            t[2] += self_ns
            t[3].add(unit)

    def summary(self) -> dict:
        with self._lock:
            # copies first: a collection while the rows are built may
            # tally into the live tables
            spans, counters = dict(self.spans), dict(self.counters)
            units = self.units
        return {"units": units,
                "spans": [{"name": n, "parent": p, "calls": t[0],
                           "in_units": len(t[3]), "total_ms": t[1] / 1e6,
                           "self_ms": t[2] / 1e6}
                          for (n, p), t in sorted(
                              spans.items(),
                              key=lambda kv: (kv[0][0], kv[0][1] or ""))],
                "counters": dict(sorted(counters.items()))}


_REC = Recorder()


class _Span:
    """A span opened while a session records."""
    __slots__ = ("name", "parent", "unit", "child_ns", "t0", "_rf")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        if not _REC.gc_hooked:
            _hook_gc()
        st = _REC.stack()
        up = st[-1] if st else None
        self.parent = None if up is None else up.name
        self.unit = _REC.top_opened(self.name) if up is None else up.unit
        self.child_ns = 0
        self._rf = torch.profiler.record_function(PREFIX + self.name)
        self._rf.__enter__()
        st.append(self)
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = perf_counter_ns() - self.t0
        self._rf.__exit__(*exc)
        st = _REC.stack()
        st.pop()
        if st:
            st[-1].child_ns += dt
        _REC.tally(self.name, self.parent, self.unit, dt, dt - self.child_ns)
        if not st:
            _REC.top_closed()
        return False


def span(name: str):
    """A span of the program named ``name`` (see the module docstring)."""
    if not _profiler._is_profiler_enabled:
        return NULL
    return _Span(name)


def count(name: str, n) -> None:
    """Adds ``n`` to the counter ``name`` while a session records."""
    if _profiler._is_profiler_enabled:
        _REC.add(name, n)


def _on_gc(phase: str, info: dict) -> None:
    local = _REC._local
    if phase == "start":
        if _profiler._is_profiler_enabled:
            sp = _Span(GC)
            sp.__enter__()
            local.gc = sp
        return
    sp = getattr(local, "gc", None)
    if sp is not None:
        local.gc = None
        sp.__exit__(None, None, None)
        _REC.add(f"gc/gen{info['generation']}", 1)


def _hook_gc() -> None:
    with _REC._lock:
        if _REC.gc_hooked:
            return
        _REC.gc_hooked = True
    gc.callbacks.append(_on_gc)


def summary() -> dict:
    """What was recorded since the last ``reset()``: ``units`` (the
    ``model/forward`` and ``stream/step`` spans begun at top level),
    ``spans`` (per name and parent, None at top level: ``calls``,
    ``in_units`` (how many units it ran in), ``total_ms``, ``self_ms``)
    and ``counters`` (totals)."""
    return _REC.summary()


def reset() -> None:
    """Clears the tallies and takes the garbage-collection callback out."""
    if _on_gc in gc.callbacks:
        gc.callbacks.remove(_on_gc)
    _REC.clear()
