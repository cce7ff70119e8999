"""Readers of per-layer metrics, each from the run's record: the timed
window's own numbers and, in a ``--trace 1`` run, the traced segment's
(``record["trace"]``, from ``harness/trace.reduce``).  A reader that finds
nothing to read returns None; a share of a roofline or a peak is never 0
for want of a reading."""
from __future__ import annotations

from typing import Optional


def _trace(record: dict, key: str) -> Optional[float]:
    t = record.get("trace")
    return None if t is None else t[key]


def loader_wait_ms(record: dict) -> Optional[float]:
    """Mean milliseconds a window unit waited for its input."""
    return record.get("loader_wait_ms")


def device_ops(record: dict) -> Optional[float]:
    """Device operations (kernels, copies, sets) per traced unit."""
    return _trace(record, "device_ops")


def device_busy_ms(record: dict) -> Optional[float]:
    """Union of the device's busy intervals per traced unit, ms."""
    return _trace(record, "busy_ms")


def device_idle_pct(record: dict) -> Optional[float]:
    """Share of the traced window with no device operation, %."""
    return _trace(record, "idle_pct")


def kernels_roofline(record: dict) -> Optional[float]:
    """The hand-written kernels' summed bound time over their summed
    traced time, %."""
    t = record.get("trace")
    if not t or not t["kernels"]:
        return None
    ks = t["kernels"].values()
    return (100.0 * sum(k["bound_s"] for k in ks)
            / sum(k["traced_s"] for k in ks))


def mfu(record: dict) -> Optional[float]:
    """The window's model FLOPs over its seconds and the card's bf16 dense
    peak, %."""
    return record.get("mfu_pct")
