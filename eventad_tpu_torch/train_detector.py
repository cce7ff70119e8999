"""Detector training entry point of the port (counterpart of the root
``train_detector.py``; reference dagr.py:76-86 with the vendored YOLOX
loss, LR schedule and EMA): the whole detector trains, through the
backbone and the ResNet, on the simOTA loss; AdamW (or SGD) after a
global-norm clip, on a YOLOX warm-up + cosine schedule; an EMA of the
weights; per epoch the mAP of the EMA weights on the validation batches,
then ``detector_latest.pt``; losses and metrics also go to a ``RunLogger``
(``<output_dir>/results/<experiment>_det_<stamp>/metrics.jsonl``).

    python -m eventad_tpu_torch.train_detector --synthetic_data true \\
        --dataset_directory /tmp/synth --epochs 2 --output_dir out
    python -m eventad_tpu_torch.train_detector --epochs 2 \\
        --train_batches 4 --val_batches 2 --output_dir out

``main`` reads the "train" split of ``dataset_directory`` (through the
training transform with ``--use_augmentations true``) and "val" through
``SequenceDataset`` and ``Loader``, as the port's ``train`` does;
``--train_batches N`` / ``--val_batches N`` read in-memory synthetic
batches instead.  ``--mesh NxM`` under ``torchrun --nproc_per_node N*M``
trains dp x tp (``parallel/``).  ``fit_detector`` takes any loaders of
``(EventBatch, BatchMeta)``.  The final ``no_aug_epochs`` epochs switch
the L1 branch on and the augmentations off.  Runs on the CUDA card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

from .config import Config, parse_args
from .models.backbone import BackboneConfig
from .models.dagr import resolve_device
from .models.detector import Detector, detector_decoded, init_detector
from .models.yolox_loss import (AnchorGeometry, convert_to_training_format,
                                logits_of_decoded, make_anchor_geometry,
                                yolox_loss)
from .parallel.mesh import (batch_is_empty, end_distributed,
                            is_main_process, process_mesh, replicated)
from .ops.group_sum import batch_stats_group
from .parallel.sharding import ShardedParams, shard_params, sharded_init
from .test_detector import detection_metrics
from .train import (dataset_loaders, in_memory_loaders, loader_args,
                    prepare_dataset)
from .utils.checkpoint import save_detector_checkpoint
from .utils.ema import EMAState, ema_init, ema_update, ema_weights
from .utils.logging import RunLogger
from .utils.result import setup_directories
from .utils.schedules import make_detector_optimizer, yolox_schedule


def anchor_geometry(bc: BackboneConfig, device=None) -> AnchorGeometry:
    """The anchors of the two detection scales (grids 2 and 3)."""
    grids = [bc.grids[2], bc.grids[3]]
    strides = [int(round(bc.height / g[1])) for g in grids]
    return make_anchor_geometry(grids, strides, device)


def make_detector_train_step(detector: Detector, cfg: Config,
                             bc: BackboneConfig, optimizer,
                             geom: AnchorGeometry,
                             sharded: ShardedParams = None):
    """``train_step(batch, ema, l1_weight=0.0) -> (ema, losses)``: one
    forward in training mode to the decoded outputs (no NMS; the BN running
    statistics move once), the simOTA loss on them with the objectness and
    class columns turned back into logits, its gradient into every
    parameter, the clipped update and the EMA update.  ``batch`` must be on
    the detector's device; ``losses`` are detached 0-dim tensors.

    With ``sharded`` (``parallel.sharding.shard_params`` over a mesh) the
    step is the JAX package's dp x tp step: ``batch`` is the rank's block
    (``parallel.mesh.shard_batch``); the shards are gathered into whole
    weights first; the BN statistics and the loss's foreground count are
    taken over the data group, so each rank's loss is its part of the
    batch's; the gradients are summed over the data group and each rank
    updates its shards, the optimizer and the EMA holding ``sharded.
    locals``; ``losses`` are the batch's (``num_fg`` summed)."""
    params = (list(detector.parameters()) if sharded is None
              else sharded.locals)
    group = None if sharded is None else sharded.data_group

    def train_step(batch, ema: EMAState, l1_weight: float = 0.0):
        bcx = bc
        if sharded is not None:
            sharded.gather()
            bcx = bc._replace(batch_size=batch.pos.shape[0])
        optimizer.zero_grad()
        with batch_stats_group(group):
            decoded = detector_decoded(detector, batch, cfg, bcx,
                                       training=True)
            tgt, tmask = convert_to_training_format(batch.bbox,
                                                    batch.bbox_mask)
            losses = yolox_loss(logits_of_decoded(decoded), tgt, tmask,
                                geom, l1_weight=l1_weight)
        losses["total"].backward()
        if sharded is not None:
            sharded.reduce_grads()
        optimizer.step()
        losses = {k: v.detach() for k, v in losses.items()}
        if group is not None:
            total = torch.stack(list(losses.values()))
            dist.all_reduce(total, group=group)
            losses = dict(zip(losses, total))
        return ema_update(ema, params), losses

    return train_step


def fit_detector(cfg: Config, train_loader, val_loader, *,
                 device=None, mesh=None) -> dict:
    """Trains the detector for ``cfg.epochs`` epochs; returns
    ``dict(detector, ema, optimizer, history, checkpoint)``.  In the
    no-aug epochs a dataset behind ``train_loader`` (``train_loader.ds``)
    loses its transform, and the loader's decode processes, which hold a
    copy of it, are stopped so that the next epoch starts them anew.

    With a ``mesh`` the step is dp x tp (``make_detector_train_step``):
    ``train_loader`` yields this rank's block of every batch, the weights
    are sharded over "model" with the optimizer state and the EMA
    (``ema`` then holds this rank's shards); every rank evaluates the
    whole validation batches with the gathered EMA weights, and rank 0
    writes the checkpoint (whole weights, EMA and optimizer state) and the
    log."""
    dev = resolve_device(device)
    main_rank = is_main_process()
    detector, bc = init_detector(
        cfg, torch.Generator().manual_seed(cfg.seed), dev)
    geom = anchor_geometry(bc, dev)
    steps_per_epoch = max(len(train_loader), 1)
    schedule = yolox_schedule(cfg.lr, warmup_steps=steps_per_epoch,
                              total_steps=cfg.epochs * steps_per_epoch)
    sharded = None
    params = list(detector.parameters())
    if mesh is not None:
        sharded = shard_params(replicated(detector), mesh)
        params = sharded.locals
    optimizer = make_detector_optimizer(
        params, cfg.optimizer, schedule, cfg.weight_decay, cfg.clip,
        grad_norm=None if sharded is None else sharded.grad_norm)
    ema = sharded_init(ema_init, sharded, params)
    train_step = make_detector_train_step(detector, cfg, bc, optimizer, geom,
                                          sharded)
    path = logger = None
    if main_rank:
        dirs = setup_directories(cfg.output_dir,
                                 cfg.experiment_name + "_det", "train")
        path = Path(dirs["model_dir"]) / "detector_latest.pt"
        logger = RunLogger(dirs["result_dir"], hparams=cfg)

    history, step = [], 0
    for epoch in range(cfg.epochs):
        t0 = time.time()
        # YOLOX's no-aug phase: the final epochs with the L1 branch on
        no_aug = (cfg.no_aug_epochs > 0
                  and epoch >= cfg.epochs - cfg.no_aug_epochs)
        l1_weight = 1.0 if no_aug else 0.0
        ds = getattr(train_loader, "ds", None)
        if no_aug and getattr(ds, "transform", None) is not None:
            print(f"epoch {epoch}: no-aug phase (L1 on, augmentations off)")
            ds.transform = None
            train_loader.close()
        losses = None
        for batch, _meta in train_loader:
            if batch_is_empty(batch, mesh):
                continue
            ema, losses = train_step(batch.to(dev), ema, l1_weight)
            step += 1
            if step % 20 == 0 and main_rank:
                logged = {k: float(v) for k, v in losses.items()}
                logger.log(logged, step=step)
                print(f"step {step}: " + " ".join(
                    f"{k} {v:.4f}" for k, v in logged.items()))
        # the mAP of the EMA weights on the live running statistics
        whole = ema if sharded is None else EMAState(
            sharded.full_values(ema.params), ema.updates)
        if sharded is not None:
            sharded.gather()
        with torch.no_grad(), ema_weights(detector.parameters(), whole):
            metrics = detection_metrics(detector, val_loader, cfg, bc, dev)
        last = {k: float(v) for k, v in (losses or {}).items()}
        history.append(dict(epoch=epoch, l1_weight=l1_weight, **last,
                            **metrics))
        opt_state = (optimizer.state_dict() if sharded is None
                     else sharded.full_optimizer_state(optimizer))
        if main_rank:
            logger.log({"epoch": epoch, **metrics})
            print(f"epoch {epoch}: loss "
                  f"{last.get('total', float('nan')):.4f} mAP "
                  f"{metrics['mAP']:.4f} mAP50 {metrics['mAP_50']:.4f} lr "
                  f"{schedule(step):.2e} ({time.time() - t0:.1f}s)",
                  flush=True)
            save_detector_checkpoint(path, detector, whole, opt_state,
                                     dict(epoch=epoch, **metrics))
    if main_rank:
        logger.close()
        print(f"checkpoint: {path}")
    return dict(detector=detector, ema=ema, optimizer=optimizer,
                history=history, checkpoint=path)


def main(argv=None):
    cfg = parse_args(argv)
    args = loader_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {dev}")
    mesh = process_mesh(cfg.mesh, dev, cfg.batch_size)
    try:
        if args.in_memory:
            train_loader, val_loader = in_memory_loaders(cfg, args, mesh)
        else:
            cfg = prepare_dataset(cfg)
            train_loader, val_loader = dataset_loaders(cfg, "train", mesh)
        try:
            return fit_detector(cfg, train_loader, val_loader, device=dev,
                                mesh=mesh)
        finally:
            train_loader.close()
            val_loader.close()
    finally:
        end_distributed()


if __name__ == "__main__":
    main(sys.argv[1:])
