"""Detector evaluation entry point of the port (counterpart of the root
``test_detector.py``; reference testing.py:16-55 with the mAP of
buffers.py): every batch through ``detector_forward`` in eval mode, the
detections and the ground-truth boxes into a ``DetectionBuffer``, then
``mAP`` and ``mAP@50``.

    python -m eventad_tpu_torch.test_detector --dataset_directory DIR
    python -m eventad_tpu_torch.test_detector --val_batches 4

``main`` reads the "val" split of ``dataset_directory`` through
``SequenceDataset`` and ``Loader`` (``--synthetic_data true`` generates the
on-disk fixture there first) and writes the first eight items' frames with
their detections and ground truth (``utils/viz.save_detection_frame``) to
``<output_dir>/test_results/<experiment>_det_<stamp>``;
``--val_batches N`` reads that many in-memory synthetic batches instead
(no frames written).  ``evaluate`` takes any loader of ``(EventBatch,
BatchMeta)``.  ``--test_checkpoint`` names a
``torch.save`` of ``{"model": detector.state_dict()}``, with the EMA
weights under ``"ema"`` where ``train_detector`` wrote it (those are then
evaluated, as the root script evaluates the EMA weights of its
checkpoint); without one the randomly initialised detector is evaluated.
Runs on the CUDA card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

from .config import Config, parse_args
from .data.batching import Loader
from .data.dataset import SequenceDataset
from .data.synthetic import synthetic_loader
from .models.dagr import resolve_device
from .models.detector import detector_forward, init_detector
from .train import loader_args, prepare_dataset
from .utils.checkpoint import load_detector_checkpoint
from .utils.detection_eval import DetectionBuffer
from .utils.result import setup_directories

VIZ_FRAMES = 8


def detection_metrics(detector, loader, cfg: Config, bc, device,
                      viz_dir=None) -> dict:
    """``mAP`` and ``mAP_50`` of ``detector`` in eval mode over a loader of
    ``(EventBatch, BatchMeta)``: every batch's detections and ground-truth
    boxes (xywh corners to xyxy) into one ``DetectionBuffer``.  With
    ``viz_dir``, the first ``VIZ_FRAMES`` items' frames go there as
    ``det_<batch>_<item>.png``."""
    buf = DetectionBuffer(num_classes=2)
    n_viz = 0
    for bi_batch, (batch, meta) in enumerate(loader):
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
            if viz_dir is not None and n_viz < VIZ_FRAMES:
                from .utils.viz import save_detection_frame
                keep = dets["mask"][bi]
                save_detection_frame(
                    Path(viz_dir) / f"det_{bi_batch}_{bi}.png",
                    batch.image[bi].numpy(),
                    detections={k: v[bi][keep] for k, v in dets.items()
                                if k != "mask"},
                    targets={"boxes": xyxy[m], "labels": gt[bi, m, 4]})
                n_viz += 1
    return buf.compute()


def evaluate(cfg: Config, loader, *, device=None, viz_dir=None) -> dict:
    dev = resolve_device(device)
    detector, bc = init_detector(
        cfg, torch.Generator().manual_seed(cfg.seed), dev)
    if cfg.test_checkpoint:
        load_detector_checkpoint(cfg.test_checkpoint, detector, dev)
        print(f"loaded {cfg.test_checkpoint}")
    metrics = detection_metrics(detector, loader, cfg, bc, dev, viz_dir)
    print(f"mAP: {metrics['mAP']:.4f}  mAP@50: {metrics['mAP_50']:.4f}")
    return metrics


def main(argv=None):
    cfg = parse_args(argv)
    args = loader_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {dev}")
    viz_dir = None
    if args.in_memory:
        loader = synthetic_loader(cfg, args.val_batches,
                                  seed=cfg.seed + 10_000)
        print(f"test batches: {len(loader)} (in memory)")
    else:
        cfg = prepare_dataset(cfg)
        viz_dir = setup_directories(cfg.output_dir,
                                    cfg.experiment_name + "_det",
                                    "test")["result_dir"]
        test_ds = SequenceDataset(cfg, Path(cfg.dataset_directory), "val")
        loader = Loader(test_ds, cfg, shuffle=False)
        print(f"test items: {len(test_ds)}")
    try:
        metrics = evaluate(cfg, loader, device=dev, viz_dir=viz_dir)
    finally:
        loader.close()
    if viz_dir is not None:
        print(f"results: {viz_dir}")
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
