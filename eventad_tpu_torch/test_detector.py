"""Detector evaluation entry point of the port (counterpart of the root
``test_detector.py``; reference testing.py:16-55 with the mAP of
buffers.py): every batch through ``detector_forward`` in eval mode, the
detections and the ground-truth boxes into a ``DetectionBuffer``, then
``mAP`` and ``mAP@50``.

    python -m eventad_tpu_torch.test_detector --val_batches 4

``evaluate`` takes any loader of ``(EventBatch, BatchMeta)``; ``main``
builds an in-memory synthetic one.  ``--test_checkpoint`` names a
``torch.save`` of ``{"model": detector.state_dict()}``, with the EMA
weights under ``"ema"`` where ``train_detector`` wrote it (those are then
evaluated, as the root script evaluates the EMA weights of its
checkpoint); without one the randomly initialised detector is evaluated.
Runs on the CUDA card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import sys

import torch

from .config import Config, parse_args
from .data.synthetic import synthetic_loader
from .models.dagr import resolve_device
from .models.detector import detector_forward, init_detector
from .train import loader_args
from .utils.checkpoint import load_detector_checkpoint
from .utils.detection_eval import DetectionBuffer


def detection_metrics(detector, loader, cfg: Config, bc, device) -> dict:
    """``mAP`` and ``mAP_50`` of ``detector`` in eval mode over a loader of
    ``(EventBatch, BatchMeta)``: every batch's detections and ground-truth
    boxes (xywh corners to xyxy) into one ``DetectionBuffer``."""
    buf = DetectionBuffer(num_classes=2)
    for batch, meta in loader:
        dets, _ = detector_forward(detector, batch.to(device), cfg, bc,
                                   no_events=cfg.no_events)
        dets = {k: v.cpu().numpy() for k, v in dets.items()}
        gt = batch.bbox.numpy()
        gt_mask = batch.bbox_mask.numpy()
        for bi in range(meta.n_items):
            m = gt_mask[bi]
            xyxy = gt[bi, :, :4].copy()
            xyxy[:, 2:4] += xyxy[:, :2]
            buf.update([{k: v[bi] for k, v in dets.items()}],
                       [{"boxes": xyxy[m], "labels": gt[bi, m, 4]}])
    return buf.compute()


def evaluate(cfg: Config, loader, *, device=None) -> dict:
    dev = resolve_device(device)
    detector, bc = init_detector(
        cfg, torch.Generator().manual_seed(cfg.seed), dev)
    if cfg.test_checkpoint:
        load_detector_checkpoint(cfg.test_checkpoint, detector, dev)
        print(f"loaded {cfg.test_checkpoint}")
    metrics = detection_metrics(detector, loader, cfg, bc, dev)
    print(f"mAP: {metrics['mAP']:.4f}  mAP@50: {metrics['mAP_50']:.4f}")
    return metrics


def main(argv=None):
    cfg = parse_args(argv)
    args = loader_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {dev}")
    loader = synthetic_loader(cfg, args.val_batches, seed=cfg.seed + 10_000)
    print(f"test batches: {len(loader)}")
    return evaluate(cfg, loader, device=dev)


if __name__ == "__main__":
    main(sys.argv[1:])
