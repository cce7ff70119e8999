"""Training entry point of the port (counterpart of the root ``train.py``;
reference train.py:46-144): frozen DAGR, anomaly head, AdamW + plateau LR,
per-epoch validation, best-AUC/AP checkpoint files, early stop when the LR
drops below ``min_lr``, crash-save on exceptions.

    python -m eventad_tpu_torch.train --epochs 3 --output_dir out

``fit`` takes any loaders of ``(EventBatch, BatchMeta)``; ``main`` builds
in-memory synthetic ones (``--train_batches``, ``--val_batches``).  Runs on
the CUDA card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .config import Config, parse_args
from .data.synthetic import synthetic_loader
from .models.dagr import graph_static_config, init_model, resolve_device
from .parallel.train_step import (make_optimizer, make_train_fns,
                                  plateau_init, plateau_update, set_lr)
from .utils import checkpoint as ckpt
from .utils.evaluation import average_precision, roc_auc


def validate(eval_step, loader):
    """``(val_loss, roc_auc, ap)`` over a loader: the summed loss per valid
    box, and the unadjusted AUC / AP of the anomaly logit (nan unless both
    classes occur)."""
    scores, labels = [], []
    total_loss, total_n = 0.0, 0
    for batch, _meta in loader:
        if batch.is_empty():
            continue
        logits, valid, labs, loss, n_valid = eval_step(batch)
        v = valid.cpu().numpy()
        scores.append(logits[..., 1].cpu().numpy()[v])
        labels.append(labs.cpu().numpy()[v])
        total_loss += float(loss)
        total_n += int(n_valid)
    if not scores or total_n == 0:
        raise RuntimeError("validation produced no valid boxes")
    scores, labels = np.concatenate(scores), np.concatenate(labels)
    if len(np.unique(labels)) < 2:
        return total_loss / total_n, float("nan"), float("nan")
    return (total_loss / total_n, roc_auc(labels, scores),
            average_precision(labels, scores))


def fit(cfg: Config, train_loader, val_loader, *, device=None,
        resume: str = "") -> dict:
    """Trains the head for ``cfg.epochs`` epochs; returns ``dict(model,
    model_dir, best_auc, best_ap, history)``."""
    dev = resolve_device(device)
    stamp = time.strftime("%Y%m%d_%H%M%S")
    model_dir = (Path(cfg.output_dir) / "models"
                 / f"{cfg.experiment_name}_{stamp}")
    model, bc, mc = init_model(cfg, torch.Generator().manual_seed(cfg.seed),
                               dev)
    gsc = graph_static_config(cfg)
    optimizer = make_optimizer(model.head.parameters(), cfg.learning_rate,
                               cfg.weight_decay, cfg.grad_clip)
    fns = make_train_fns(model, bc, mc, gsc, optimizer, dev)

    start_epoch, best_auc, best_ap = 0, 0.0, 0.0
    plateau = plateau_init()
    if resume:
        extra = ckpt.load_checkpoint(resume, model, optimizer, dev)
        start_epoch = extra.get("epoch", -1) + 1
        best_auc = extra.get("best_auc", 0.0)
        best_ap = extra.get("best_ap", 0.0)
        print(f"resumed from {resume} at epoch {start_epoch}")

    dropout_rng = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    history = []
    epoch = start_epoch
    try:
        for epoch in range(start_epoch, cfg.epochs):
            lr = cfg.learning_rate * plateau.scale
            set_lr(optimizer, lr)
            t0 = time.time()
            losses, skipped = [], 0
            for batch, _meta in train_loader:
                if batch.is_empty():
                    skipped += 1
                    continue
                m = fns.train_step(batch, dropout_rng)
                if not m["finite"]:
                    print("warning: non-finite loss/grads; step skipped")
                    skipped += 1
                    continue
                nv = int(m["n_valid"])
                if nv > 0:
                    losses.append(float(m["loss"]) / nv)
            if not losses:
                raise RuntimeError("No valid batches during training")
            train_loss = float(np.mean(losses))
            val_loss, auc, ap = validate(fns.eval_step, val_loader)
            plateau = plateau_update(plateau, val_loss,
                                     factor=cfg.lr_decay_factor,
                                     patience=cfg.lr_patience)
            is_best_auc = auc == auc and auc > best_auc
            is_best_ap = ap == ap and ap > best_ap
            best_auc = max(best_auc, auc if auc == auc else 0.0)
            best_ap = max(best_ap, ap if ap == ap else 0.0)
            ckpt.save_checkpoint(model_dir, model, optimizer, epoch,
                                 best_auc, best_ap, is_best_auc, is_best_ap)
            history.append(dict(epoch=epoch, train_loss=train_loss,
                                val_loss=val_loss, auc=auc, ap=ap, lr=lr,
                                skipped=skipped))
            print(f"epoch {epoch}: train {train_loss:.4f} val {val_loss:.4f} "
                  f"auc {auc:.4f} ap {ap:.4f} lr {lr:.2e} "
                  f"({time.time() - t0:.1f}s)", flush=True)
            if lr < cfg.min_lr:
                print(f"lr {lr:.2e} below min_lr, early stop")
                break
    except Exception as e:  # crash-save (reference train.py:134-140)
        print(f"Error during training: {e}")
        ckpt.save_checkpoint(model_dir, model, optimizer, epoch, best_auc,
                             best_ap, False, False)
        raise
    print(f"done. best AUC {best_auc:.4f} best AP {best_ap:.4f}")
    print(f"models: {model_dir}")
    return dict(model=model, model_dir=model_dir, best_auc=best_auc,
                best_ap=best_ap, history=history)


def loader_args(argv):
    """The arguments of the synthetic loaders and the device, beside the
    :class:`Config` fields."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default=None)
    p.add_argument("--train_batches", type=int, default=8)
    p.add_argument("--val_batches", type=int, default=4)
    p.add_argument("--resume", default="")
    return p.parse_known_args(argv)[0]


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
    return fit(cfg, train_loader, val_loader, device=dev, resume=args.resume)


if __name__ == "__main__":
    main(sys.argv[1:])
