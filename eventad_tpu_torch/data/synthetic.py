"""In-memory synthetic batches: the same arrays as
``eventad_tpu.data.synthetic.make_synthetic_batch`` from the same seed."""
from __future__ import annotations

import numpy as np
import torch

from ..config import Config
from ..native import queue_ranks
from .batching import MAX_DETECTIONS, BatchMeta, EventBatch, rank_items


def make_synthetic_batch(cfg: Config, seed: int = 0,
                         events_per_item: int = None,
                         boxes_per_item: int = 4) -> EventBatch:
    """Returns an :class:`EventBatch` of CPU tensors (``.to(device)`` moves
    it).  The numpy draws follow the reference generator call for call."""
    rng = np.random.RandomState(seed)
    b = cfg.batch_size
    w, h = cfg.model_width, cfg.model_height
    n = events_per_item or cfg.event_buckets[0]
    s = cfg.max_boxes + 1

    x = rng.randint(0, w, (b, n)).astype(np.int32)
    y = rng.randint(0, h, (b, n)).astype(np.int32)
    t = np.sort(rng.randint(0, cfg.time_window_us, (b, n)), axis=1) \
        .astype(np.int32)
    pos = np.stack([x, y, t], axis=-1)
    pol = rng.choice([-1.0, 1.0], (b, n)).astype(np.float32)
    valid = np.ones((b, n), bool)
    rank = np.stack([queue_ranks(x[i], y[i], w, h) for i in range(b)])
    image = rng.rand(b, h, w, 3).astype(np.float32)

    boxes = np.zeros((b, 2, s, 4), np.float32)
    present = np.zeros((b, 2, s), bool)
    labels = np.zeros((b, s), np.int32)
    bbox_m = np.zeros((b, MAX_DETECTIONS), bool)
    bbox = np.zeros((b, MAX_DETECTIONS, 6), np.float32)
    for bi in range(b):
        for k in range(boxes_per_item):
            tid = k + 1
            bw = rng.randint(8, max(w // 4, 9))
            bh = rng.randint(8, max(h // 4, 9))
            bx = rng.randint(0, max(w - bw, 1))
            by = rng.randint(0, max(h - bh, 1))
            cls = int(rng.rand() > 0.7)
            boxes[bi, :, tid] = (bx, by, bw, bh)
            present[bi, :, tid] = True
            labels[bi, tid] = cls
            bbox_m[bi, k] = True
            bbox[bi, k] = (bx, by, bw, bh, cls, tid)
    return EventBatch(*(torch.from_numpy(a) for a in (
        pos, pol, valid, rank, image, boxes, present, labels, bbox_m,
        bbox_m.copy(), bbox)))


class SyntheticLoader:
    """In-memory stand-in for the on-disk loader: ``n_batches`` synthetic
    batches (seeds ``seed``, ``seed + 1``, ...), made once and yielded as
    ``(EventBatch, BatchMeta)`` in the same order on every pass.  Batch
    ``i`` holds ``batch_size`` consecutive frames of the video
    ``synthetic_<i // batches_per_video>``.  ``rank`` / ``world``: the
    rank's block of every batch, as ``Loader`` gives it."""

    def __init__(self, cfg: Config, n_batches: int, seed: int = 0, *,
                 boxes_per_item: int = 4, batches_per_video: int = 2,
                 rank: int = 0, world: int = 1):
        b = cfg.batch_size
        part = rank_items(b, rank, world)
        self.items = []
        for i in range(n_batches):
            batch = make_synthetic_batch(cfg, seed=seed + i,
                                         boxes_per_item=boxes_per_item)
            first = (i % batches_per_video) * b
            frames = list(range(first, first + b))[part]
            meta = BatchMeta(
                sequences=[f"synthetic_{i // batches_per_video:04d}"]
                * len(frames), frame_ids=frames, n_items=len(frames))
            self.items.append((batch.select(part), meta))

    def __iter__(self):
        return iter(self.items)

    def __len__(self):
        return len(self.items)

    def close(self):
        """Nothing to stop (a ``Loader`` stops its decode processes)."""


synthetic_loader = SyntheticLoader
