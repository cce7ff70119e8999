"""Inference throughput measurement (counterpart of
``eventad_tpu/utils/fps.py``; reference utils/fps.py:6-96).

Every timed batch ends in a device synchronise, as the reference brackets
each batch with ``torch.cuda.synchronize``.  FPS counts ``len(bbox) +
len(bbox0)`` object instances per second (utils/fps.py:58), the unit of the
reference's published number."""
from __future__ import annotations

import time
from typing import Callable

import torch


def _sync(out) -> None:
    """Waits for the device that holds ``out`` (nothing to wait for on the
    CPU)."""
    leaf = out
    while isinstance(leaf, (tuple, list)):
        leaf = leaf[0]
    if leaf.is_cuda:
        torch.cuda.synchronize(leaf.device)


def measure_fps(forward_fn: Callable, loader, *, warmup_batches: int = 5,
                num_batches: int = 20) -> dict:
    batch_times, batch_sizes = [], []
    for i, (batch, _meta) in enumerate(loader):
        if batch.is_empty():
            continue
        if i < warmup_batches:
            _sync(forward_fn(batch))
            continue
        if len(batch_times) >= num_batches:
            break
        n_boxes = int(batch.bbox_mask.sum()) + int(batch.bbox0_mask.sum())
        batch_sizes.append(n_boxes)
        t0 = time.perf_counter()
        _sync(forward_fn(batch))
        batch_times.append(time.perf_counter() - t0)

    total_time = sum(batch_times)
    total_samples = sum(batch_sizes)
    fps = total_samples / total_time if total_time > 0 else 0.0
    return {
        "fps": fps,
        "avg_batch_size": (total_samples / len(batch_sizes)
                           if batch_sizes else 0.0),
        "total_time": total_time,
        "num_batches": len(batch_times),
        "p50_ms": (sorted(batch_times)[len(batch_times) // 2] * 1e3
                   if batch_times else float("nan")),
    }
