"""Batch container of the port and the host-side per-pixel queue ranks.

Counterpart of ``eventad_tpu/data/batching.py`` (``EventBatch``,
``BatchMeta``) and ``eventad_tpu/native.queue_ranks``.  The TPU staging
fields (``search_starts``, ``image_s2d``) are not carried, nor the optional
host ``pool_tables`` (the pooling computes its cell sums from the events),
nor the previous frame's raw detection list ``bbox0`` (only its mask, which
the evaluation loop reads).
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple

import numpy as np
import torch


class EventBatch(NamedTuple):
    """One batch, every field a tensor (layouts as in the JAX package)."""
    pos: torch.Tensor          # [B, N, 3] int32 (x, y, t_us)
    polarity: torch.Tensor     # [B, N] float32 +-1
    valid: torch.Tensor        # [B, N] bool
    rank: torch.Tensor         # [B, N] int32 per-pixel recency rank
    image: torch.Tensor        # [B, H, W, 3] float32 in [0, 1]
    boxes: torch.Tensor        # [B, 2, S, 4] float32 xywh pixels
    box_present: torch.Tensor  # [B, 2, S] bool
    box_labels: torch.Tensor   # [B, S] int32
    bbox_mask: torch.Tensor    # [B, D] bool, raw current-frame detections
    bbox0_mask: torch.Tensor   # [B, D] bool, raw previous-frame detections
    bbox: torch.Tensor         # [B, D, 6] float32 (x, y, w, h, class, track)

    def to(self, device) -> "EventBatch":
        return EventBatch(*(a.to(device) for a in self))

    def is_empty(self) -> bool:
        """No current-frame box in the whole batch: the training and
        evaluation loops skip such a batch."""
        return not bool(self.bbox_mask.any())


@dataclasses.dataclass
class BatchMeta:
    """Host-side metadata the metrics pipeline needs."""
    sequences: List[str]
    frame_ids: List[int]
    n_items: int


def queue_ranks(x: np.ndarray, y: np.ndarray, width: int,
                height: int) -> np.ndarray:
    """Per-pixel recency rank: the number of later events at the same pixel
    (the slot of each event in the reference's per-pixel FIFO once the whole
    window is inserted, ev_graph.cu:169-212)."""
    n = len(x)
    pix = np.asarray(y, np.int64) * width + np.asarray(x, np.int64)
    order = np.argsort(pix, kind="stable")
    sp = pix[order]
    pos = np.arange(n)
    is_last = np.concatenate([sp[1:] != sp[:-1], [True]])
    last_pos = np.where(is_last, pos, n)
    last_pos = np.minimum.accumulate(last_pos[::-1])[::-1]
    out = np.empty(n, np.int32)
    out[order] = (last_pos - pos).astype(np.int32)
    return out
