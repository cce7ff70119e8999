"""Detector training entry point of the port (counterpart of the root
``train_detector.py``; reference dagr.py:76-86 with the vendored YOLOX
loss, LR schedule and EMA): the whole detector trains, through the
backbone and the ResNet, on the simOTA loss; AdamW (or SGD) after a
global-norm clip, on a YOLOX warm-up + cosine schedule; an EMA of the
weights; per epoch the mAP of the EMA weights on the validation batches,
then ``detector_latest.pt``.

    python -m eventad_tpu_torch.train_detector --epochs 2 \\
        --train_batches 4 --val_batches 2 --output_dir out

``fit_detector`` takes any loaders of ``(EventBatch, BatchMeta)``; ``main``
builds in-memory synthetic ones (``--train_batches``, ``--val_batches``),
as the port's ``train`` does: the on-disk loader, its augmentations and
the run logger are not ported yet.  The final ``no_aug_epochs`` epochs
switch the L1 branch on.  Runs on the CUDA card unless ``--device cpu`` is
given.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

from .config import Config, parse_args
from .data.synthetic import synthetic_loader
from .models.backbone import BackboneConfig
from .models.dagr import resolve_device
from .models.detector import Detector, detector_decoded, init_detector
from .models.yolox_loss import (AnchorGeometry, convert_to_training_format,
                                logits_of_decoded, make_anchor_geometry,
                                yolox_loss)
from .test_detector import detection_metrics
from .train import loader_args
from .utils.checkpoint import save_detector_checkpoint
from .utils.ema import EMAState, ema_init, ema_update, ema_weights
from .utils.schedules import make_detector_optimizer, yolox_schedule


def anchor_geometry(bc: BackboneConfig, device=None) -> AnchorGeometry:
    """The anchors of the two detection scales (grids 2 and 3)."""
    grids = [bc.grids[2], bc.grids[3]]
    strides = [int(round(bc.height / g[1])) for g in grids]
    return make_anchor_geometry(grids, strides, device)


def make_detector_train_step(detector: Detector, cfg: Config,
                             bc: BackboneConfig, optimizer,
                             geom: AnchorGeometry):
    """``train_step(batch, ema, l1_weight=0.0) -> (ema, losses)``: one
    forward in training mode to the decoded outputs (no NMS; the BN running
    statistics move once), the simOTA loss on them with the objectness and
    class columns turned back into logits, its gradient into every
    parameter, the clipped update and the EMA update.  ``batch`` must be on
    the detector's device; ``losses`` are detached 0-dim tensors."""
    params = list(detector.parameters())

    def train_step(batch, ema: EMAState, l1_weight: float = 0.0):
        optimizer.zero_grad()
        decoded = detector_decoded(detector, batch, cfg, bc, training=True)
        tgt, tmask = convert_to_training_format(batch.bbox, batch.bbox_mask)
        losses = yolox_loss(logits_of_decoded(decoded), tgt, tmask, geom,
                            l1_weight=l1_weight)
        losses["total"].backward()
        optimizer.step()
        return (ema_update(ema, params),
                {k: v.detach() for k, v in losses.items()})

    return train_step


def fit_detector(cfg: Config, train_loader, val_loader, *,
                 device=None) -> dict:
    """Trains the detector for ``cfg.epochs`` epochs; returns
    ``dict(detector, ema, optimizer, history, checkpoint)``."""
    dev = resolve_device(device)
    detector, bc = init_detector(
        cfg, torch.Generator().manual_seed(cfg.seed), dev)
    geom = anchor_geometry(bc, dev)
    steps_per_epoch = max(len(train_loader), 1)
    schedule = yolox_schedule(cfg.lr, warmup_steps=steps_per_epoch,
                              total_steps=cfg.epochs * steps_per_epoch)
    optimizer = make_detector_optimizer(detector.parameters(), cfg.optimizer,
                                        schedule, cfg.weight_decay, cfg.clip)
    ema = ema_init(detector.parameters())
    train_step = make_detector_train_step(detector, cfg, bc, optimizer, geom)
    stamp = time.strftime("%Y%m%d_%H%M%S")
    path = (Path(cfg.output_dir) / "models"
            / f"{cfg.experiment_name}_det_{stamp}" / "detector_latest.pt")

    history, step = [], 0
    for epoch in range(cfg.epochs):
        t0 = time.time()
        # YOLOX's no-aug phase: the final epochs with the L1 branch on
        no_aug = (cfg.no_aug_epochs > 0
                  and epoch >= cfg.epochs - cfg.no_aug_epochs)
        l1_weight = 1.0 if no_aug else 0.0
        losses = None
        for batch, _meta in train_loader:
            if not bool(batch.bbox_mask.any()):
                continue
            ema, losses = train_step(batch.to(dev), ema, l1_weight)
            step += 1
            if step % 20 == 0:
                print(f"step {step}: " + " ".join(
                    f"{k} {float(v):.4f}" for k, v in losses.items()))
        # the mAP of the EMA weights on the live running statistics
        with torch.no_grad(), ema_weights(detector.parameters(), ema):
            metrics = detection_metrics(detector, val_loader, cfg, bc, dev)
        last = {k: float(v) for k, v in (losses or {}).items()}
        history.append(dict(epoch=epoch, l1_weight=l1_weight, **last,
                            **metrics))
        print(f"epoch {epoch}: loss {last.get('total', float('nan')):.4f} "
              f"mAP {metrics['mAP']:.4f} mAP50 {metrics['mAP_50']:.4f} "
              f"lr {schedule(step):.2e} ({time.time() - t0:.1f}s)",
              flush=True)
        save_detector_checkpoint(path, detector, ema, optimizer,
                                 dict(epoch=epoch, **metrics))
    print(f"checkpoint: {path}")
    return dict(detector=detector, ema=ema, optimizer=optimizer,
                history=history, checkpoint=path)


def main(argv=None):
    cfg = parse_args(argv)
    args = loader_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {dev}")
    train_loader = synthetic_loader(cfg, args.train_batches, seed=cfg.seed)
    val_loader = synthetic_loader(cfg, args.val_batches,
                                  seed=cfg.seed + 10_000)
    print(f"train batches: {len(train_loader)}, val batches: "
          f"{len(val_loader)}")
    return fit_detector(cfg, train_loader, val_loader, device=dev)


if __name__ == "__main__":
    main(sys.argv[1:])
