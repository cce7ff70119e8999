"""Test entry point of the port (counterpart of the root ``test.py``;
reference test.py:17-110): collect predictions, compute bbox AUC/AP, frame
AUC and mTTA, measure FPS, compute mRESPONSE with the measured FPS, and
print the metrics summary.

    python -m eventad_tpu_torch.test --output_dir out

``evaluate`` takes any loader of ``(EventBatch, BatchMeta)``; ``main``
builds an in-memory synthetic one (``--val_batches``).  Runs on the CUDA
card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .config import Config, parse_args
from .data.synthetic import synthetic_loader
from .models.dagr import graph_static_config, init_model, resolve_device
from .parallel.train_step import make_optimizer, make_train_fns
from .train import loader_args
from .utils import checkpoint as ckpt
from .utils.evaluation import (calculate_bbox_metrics,
                               calculate_frame_metrics,
                               calculate_response_metrics,
                               calculate_tta_metrics)
from .utils.fps import measure_fps
from .utils.predict import collect_predictions


def _fmt(v):
    return "N/A" if v is None or np.isnan(v) else f"{v:.4f}"


def evaluate(cfg: Config, loader, *, device=None, video_toa=None) -> dict:
    """Evaluates the best checkpoint under ``cfg.output_dir`` (or
    ``cfg.test_checkpoint``; a randomly initialised model if there is none)
    over ``loader``."""
    dev = resolve_device(device)
    model, bc, mc = init_model(cfg, torch.Generator().manual_seed(cfg.seed),
                               dev)
    optimizer = make_optimizer(model.head.parameters(), cfg.learning_rate,
                               cfg.weight_decay, cfg.grad_clip)
    fns = make_train_fns(model, bc, mc, graph_static_config(cfg), optimizer,
                         dev)
    try:
        path = ckpt.find_best_checkpoint(cfg.output_dir, cfg.experiment_name,
                                         cfg.test_checkpoint)
        ckpt.load_checkpoint(path, model, device=dev)
        print(f"loaded checkpoint {path}")
    except FileNotFoundError as e:
        print(f"warning: {e}; evaluating randomly initialised model")

    def forward(batch):
        logits, valid, labels, _loss, _nv = fns.eval_step(batch)
        return (logits.cpu().numpy(), valid.cpu().numpy(),
                labels.cpu().numpy())

    results = collect_predictions(
        forward, loader, threshold=cfg.threshold,
        legacy_frame_collapse=cfg.legacy_frame_collapse)
    bbox = calculate_bbox_metrics(results["all_labels"],
                                  results["all_scores"])
    frame = calculate_frame_metrics(results["frame_data"])
    tta = calculate_tta_metrics(results["video_predictions"],
                                results["video_first_anomaly"], video_toa)
    fps = None
    if cfg.measure_fps:
        fps = measure_fps(fns.eval_step, loader,
                          warmup_batches=cfg.fps_warmup_batches,
                          num_batches=cfg.fps_num_batches)
    response = calculate_response_metrics(
        results["video_predictions"],
        fps=fps["fps"] if fps and fps["fps"] > 0 else 579)
    print("\n==== Main Metrics Summary ====")
    print(f"AUC: {_fmt(bbox.get('auc'))}")
    print(f"AP: {_fmt(bbox.get('ap'))}")
    print(f"AUC-Frame: {_fmt(frame.get('auc_frame'))}")
    if fps:
        print(f"FPS: {fps['fps']:.2f}")
    print(f"mTTA: {_fmt(tta.get('mtta'))}")
    print(f"mRESPONSE: {_fmt(response.get('mresponse'))}")
    print("========================")
    return dict(bbox=bbox, frame=frame, tta=tta, response=response, fps=fps)


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
