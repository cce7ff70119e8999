"""Readers of the streaming detector's own spans in a ``--trace 1`` run
(``eventad_tpu_torch/streaming/detect``), per unit as
``program_spans.span_ms`` reads them; None where the program has no
such span summary."""
from __future__ import annotations

from typing import Optional

from .program_spans import span_ms


def read_detections_ms(record: dict) -> Optional[float]:
    """``stream/read_detections``: the pooled levels, both heads, the
    decode and NMS."""
    return span_ms(record, "stream/read_detections")


def gnn_head_ms(record: dict) -> Optional[float]:
    """``detect/gnn_head``: both scales of the GNN head and the hybrid
    sum."""
    return span_ms(record, "detect/gnn_head")


def nms_ms(record: dict) -> Optional[float]:
    """``detect/nms``: the greedy class-offset NMS."""
    return span_ms(record, "detect/nms")
