"""The traced segment of a ``--trace 1`` run and its reduction.

One ``torch.profiler`` session, the process's first (later sessions lose
device events on this card), over a fixed count of the loop's units after
the timed window.  The harness marks its own spans in it (``span``):
taking the next input, the copy to the card, the program's call, the copy
back.  While it runs, the hand-written kernels' wrappers are wrapped so
that each call's arguments and result are kept (``KernelCalls``); the
frozen bound rule turns them into the least time the card could take.

Reduction: the union of device intervals (busy), the traced window from
the first span's start to the last span's end, device operations by name,
the hand-written kernels' traced time beside their bound, and the longest
idle gaps of the card named by the span the host was in."""
from __future__ import annotations

import contextlib
from typing import Dict, List

from ..frozen.counts import bound_seconds

# hand-written kernels: the wrapper (module, function) in the program and
# the fragment of its kernel's name in a trace
KERNELS = {
    "K1": ("eventad_tpu_torch.ops.event_graph", "build_graph_cuda",
           "search_kernel"),
    "K2": ("eventad_tpu_torch.ops.spline_fused", "fused_two_block_cuda",
           "level0_block_kernel"),
    "K3": ("eventad_tpu_torch.ops.spline_shift", "shift_spline_conv_cuda",
           "shift_block_kernel"),
    "K4": ("eventad_tpu_torch.ops.upsample_flat", "upsample_rows_cuda",
           "upsample_rows_kernel"),
    "K6a": ("eventad_tpu_torch.ops.gather_window", "gather_window_rows_cuda",
            "gather_rows_kernel"),
}
SPAN_PREFIX = "bench/"


def span(name: str):
    """A harness span in the trace (a ``record_function`` range)."""
    from torch.profiler import record_function
    return record_function(SPAN_PREFIX + name)


class KernelCalls:
    """While active, every call of a hand-written kernel's wrapper is
    kept as ``(kernel, args, kwargs, result)``."""

    def __init__(self):
        self.calls: List[tuple] = []
        self._saved = []

    def __enter__(self):
        import importlib
        for k, (mod_name, fn_name, _) in KERNELS.items():
            mod = importlib.import_module(mod_name)
            orig = getattr(mod, fn_name)

            def wrapped(*a, _k=k, _orig=orig, **kw):
                out = _orig(*a, **kw)
                self.calls.append((_k, a, kw, out))
                return out
            wrapped.launches = getattr(orig, "launches", 0)
            self._saved.append((mod, fn_name, orig))
            setattr(mod, fn_name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, fn_name, orig in self._saved:
            setattr(mod, fn_name, orig)
        self._saved = []

    def bounds(self) -> Dict[str, float]:
        """Seconds of the least time per kernel, summed over its calls."""
        out: Dict[str, float] = {}
        for k, a, kw, res in self.calls:
            out[k] = out.get(k, 0.0) + bound_seconds(k, a, kw, res)
        return out


@contextlib.contextmanager
def traced():
    """The profiler session over the block; yields the profile."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield prof
        torch.cuda.synchronize()


def _short(name: str, width: int = 120) -> str:
    """A kernel's name without the template arguments past ``width``."""
    return name if len(name) <= width else name[:width - 3] + "..."


def _union(intervals) -> List[tuple]:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce(prof, units: int, kernel_bounds: Dict[str, float]) -> dict:
    """The traced segment's numbers: ``busy_s``, ``window_s``,
    ``device_ops`` per unit, ``busy_ms`` per unit, ``idle_pct``, per
    kernel ``{"traced_s", "bound_s", "roofline_pct"}``, and ``breakdown``
    (the ten device operations that took most time and the ten longest
    idle gaps, named by the harness span the host was in).  Raises when the
    trace holds no device operation or no span."""
    events = prof.events()
    dev, spans = [], []
    for e in events:
        if getattr(e, "is_user_annotation", False) or \
                e.name.startswith(SPAN_PREFIX):
            if not str(e.device_type).endswith("CUDA") and \
                    e.name.startswith(SPAN_PREFIX):
                spans.append((e.time_range.start, e.time_range.end,
                              e.name[len(SPAN_PREFIX):]))
            continue
        if str(e.device_type).endswith("CUDA"):
            dev.append(e)
    if not dev or not spans:
        raise RuntimeError(f"trace: {len(dev)} device operations, "
                           f"{len(spans)} harness spans")
    w0 = min(s for s, _, _ in spans)
    w1 = max(e for _, e, _ in spans)
    busy = _union((e.time_range.start, e.time_range.end) for e in dev)
    busy_us = sum(e - s for s, e in busy)
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start)
    gaps = []
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        if s1 > e0:
            mid = (e0 + s1) / 2
            inner = [sp for sp in spans if sp[0] <= mid <= sp[1]]
            name = (min(inner, key=lambda sp: sp[1] - sp[0])[2] if inner
                    else "between spans")
            gaps.append((s1 - e0, name))
    gaps.sort(reverse=True)
    kernels = {}
    for k, (_, _, frag) in KERNELS.items():
        t_us = sum(v for n, v in by_name.items() if frag in n)
        if t_us > 0 and k in kernel_bounds:
            kernels[k] = {"traced_s": t_us / 1e6,
                          "bound_s": kernel_bounds[k],
                          "roofline_pct": 100.0 * kernel_bounds[k]
                          / (t_us / 1e6)}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top = [(_short(n), v) for n, v in top]
    window_us = w1 - w0
    return {
        "busy_s": busy_us / 1e6, "window_s": window_us / 1e6,
        "device_ops": len(dev) / units, "busy_ms": busy_us / 1e3 / units,
        "idle_pct": 100.0 * (1.0 - busy_us / window_us),
        "kernels": kernels,
        "breakdown": {"device_ops": [[n, v / 1e6] for n, v in top],
                      "idle_gaps": [[n, g / 1e6] for g, n in gaps[:10]]},
    }
