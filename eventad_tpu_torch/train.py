"""Training entry point of the port (counterpart of the root ``train.py``;
reference train.py:46-144): frozen DAGR, anomaly head, AdamW + plateau LR,
per-epoch validation with ROC/PR plots every ``plot_interval`` epochs, the
CSV of epochs, best-AUC/AP checkpoint files, early stop when the LR drops
below ``min_lr``, crash-save on exceptions.

    python -m eventad_tpu_torch.train --dataset_directory ./data/detector/ROL
    python -m eventad_tpu_torch.train --synthetic_data true \
        --dataset_directory /tmp/synth --epochs 3 --output_dir out

``main`` reads the split ``train_split`` (the reference's quirk: "test",
with the testing transform; ``--use_augmentations true`` for the training
transform) and "val" of ``dataset_directory`` through ``SequenceDataset``
and ``Loader``; ``--synthetic_data true`` generates the on-disk fixture
there first.  ``--train_batches N`` / ``--val_batches N`` read that many
in-memory synthetic batches instead.  ``fit`` takes any loaders of
``(EventBatch, BatchMeta)``.  Runs on the CUDA card unless ``--device
cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

from .config import Config, parse_args
from .data.batching import Loader
from .data.dataset import SequenceDataset, check_dataset_balance
from .data.synthetic import synthetic_loader
from .models.dagr import graph_static_config, init_model, resolve_device
from .parallel.train_step import (make_optimizer, make_train_fns,
                                  plateau_init, plateau_update, set_lr)
from .utils import checkpoint as ckpt
from .utils.result import (append_epoch_row, setup_directories,
                           setup_result_file)
from .utils.visualization import validate_and_visualize


def fit(cfg: Config, train_loader, val_loader, *, device=None,
        resume: str = "") -> dict:
    """Trains the head for ``cfg.epochs`` epochs; returns ``dict(model,
    model_dir, result_dir, best_auc, best_ap, history)``."""
    dev = resolve_device(device)
    dirs = setup_directories(cfg.output_dir, cfg.experiment_name, "train")
    model_dir, result_dir = Path(dirs["model_dir"]), dirs["result_dir"]
    result_file = setup_result_file(result_dir, cfg)
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
            val_loss, auc, ap = validate_and_visualize(
                fns.eval_step, val_loader, result_dir, epoch,
                plot=(epoch % cfg.plot_interval == 0))
            plateau = plateau_update(plateau, val_loss,
                                     factor=cfg.lr_decay_factor,
                                     patience=cfg.lr_patience)
            append_epoch_row(result_file, epoch, train_loss, val_loss, auc,
                             ap, lr)
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
    print(f"models: {model_dir}\nresults: {result_dir}")
    return dict(model=model, model_dir=model_dir, result_dir=result_dir,
                best_auc=best_auc, best_ap=best_ap, history=history)


def loader_args(argv):
    """The device and the in-memory batch counts, beside the
    :class:`Config` fields.  ``--train_batches`` or ``--val_batches``
    selects in-memory synthetic batches (8 and 4 where one is not given)
    instead of the dataset directory."""
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--device", default=None)
    p.add_argument("--train_batches", type=int, default=None)
    p.add_argument("--val_batches", type=int, default=None)
    args = p.parse_known_args(argv)[0]
    args.in_memory = (args.train_batches is not None
                      or args.val_batches is not None)
    if args.train_batches is None:
        args.train_batches = 8
    if args.val_batches is None:
        args.val_batches = 4
    return args


def prepare_dataset(cfg: Config) -> Config:
    """``--synthetic_data true``: generates the on-disk fixture into
    ``dataset_directory`` when it holds no ``rol_split.yaml``, and points
    ``split`` and ``toa`` at its files."""
    if not cfg.synthetic_data:
        return cfg
    root = Path(cfg.dataset_directory)
    if not (root / "rol_split.yaml").exists():
        from .data.fixtures import generate_dataset
        print("generating synthetic fixture data ...")
        generate_dataset(root, cfg)
    return cfg.replace(split=str(root / "rol_split.yaml"),
                       toa=str(root / "toa_values.json"))


def dataset_loaders(cfg: Config, train_split: str):
    """``(train, val)`` loaders of the dataset directory: ``train_split``
    shuffled with ``cfg.seed``, through the reference's training transform
    where ``cfg.use_augmentations``; "val" in order."""
    transform = None
    if cfg.use_augmentations:
        from .data.augment import training_transform
        transform = training_transform(cfg, seed=cfg.seed)
    root = Path(cfg.dataset_directory)
    train_ds = SequenceDataset(cfg, root, train_split, transform=transform)
    val_ds = SequenceDataset(cfg, root, "val")
    print(f"train items: {len(train_ds)}, val items: {len(val_ds)}")
    return (Loader(train_ds, cfg, shuffle=True, seed=cfg.seed),
            Loader(val_ds, cfg, shuffle=False))


def main(argv=None):
    cfg = parse_args(argv)
    args = loader_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {dev}")
    if args.in_memory:
        train_loader = synthetic_loader(cfg, args.train_batches,
                                        seed=cfg.seed)
        val_loader = synthetic_loader(cfg, args.val_batches,
                                      seed=cfg.seed + 10_000)
        print(f"train batches: {len(train_loader)}, val batches: "
              f"{len(val_loader)} (in memory)")
    else:
        cfg = prepare_dataset(cfg)
        train_loader, val_loader = dataset_loaders(cfg, cfg.train_split)
    try:
        if cfg.check_balance:
            check_dataset_balance({"train": train_loader,
                                   "val": val_loader})
        return fit(cfg, train_loader, val_loader, device=dev,
                   resume=cfg.pretrained_model or cfg.resume)
    finally:
        train_loader.close()
        val_loader.close()


if __name__ == "__main__":
    main(sys.argv[1:])
