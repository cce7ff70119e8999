"""Readers of the program's own spans (``eventad_tpu_torch/utils/spans``)
in a ``--trace 1`` run.

The program records its spans only while a ``torch.profiler`` session
records, so what it holds when the result line is written is the traced
segment's: the timed window and the set-up run without a session.  Each
number is per unit, the unit being the program's own count of the
``model/forward`` or ``stream/step`` spans it began at top level.  A span
the segment never entered reads 0.  A run without the traced segment
(``record["trace"]`` absent), or a program without the module, reads
None.  The times are host milliseconds under the profiler, so they hold
its cost per operation, as every number of the traced segment does."""
from __future__ import annotations

import importlib
import importlib.util
from typing import Optional

MODULE = "eventad_tpu_torch.utils.spans"


def summary(record: dict) -> Optional[dict]:
    """The program's summary of the traced segment, or None."""
    if record.get("trace") is None or \
            importlib.util.find_spec(MODULE) is None:
        return None
    s = importlib.import_module(MODULE).summary()
    return s if s["units"] else None


def span_ms(record: dict, name: str) -> Optional[float]:
    """Host milliseconds in the spans ``name`` per unit, summed over the
    parents they ran under."""
    s = summary(record)
    if s is None:
        return None
    return sum(r["total_ms"] for r in s["spans"]
               if r["name"] == name) / s["units"]


def item_ms(record: dict) -> Optional[float]:
    """``data/item``: the dataset cutting a batch's items."""
    return span_ms(record, "data/item")


def collate_ms(record: dict) -> Optional[float]:
    """``data/collate``: padding the items into a batch."""
    return span_ms(record, "data/collate")


def forward_host_ms(record: dict) -> Optional[float]:
    """``model/forward``: the host's time to issue one forward."""
    return span_ms(record, "model/forward")


def gc_ms(record: dict) -> Optional[float]:
    """``runtime/gc``: the interpreter's garbage collections."""
    return span_ms(record, "runtime/gc")


def append_ms(record: dict) -> Optional[float]:
    """``stream/append``: a chunk into the level-0 caches."""
    return span_ms(record, "stream/append")


def read_ms(record: dict) -> Optional[float]:
    """``stream/read_scores``: the pooled levels and the head."""
    return span_ms(record, "stream/read_scores")
