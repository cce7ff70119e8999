"""Test entry point of the port (counterpart of the root ``test.py``;
reference test.py:17-110): collect predictions, compute bbox AUC/AP, frame
AUC and mTTA, measure FPS, compute mRESPONSE with the measured FPS, and
write ``test_results.csv`` and ``metrics_summary.txt`` and print the
metrics summary.

    python -m eventad_tpu_torch.test --dataset_directory ./data/detector/ROL \
        --output_dir out

``main`` reads the "val" split of ``dataset_directory`` through
``SequenceDataset`` and ``Loader`` (``--synthetic_data true`` generates the
on-disk fixture there first); ``--val_batches N`` reads that many in-memory
synthetic batches instead.  ``evaluate`` takes any loader of
``(EventBatch, BatchMeta)``.  Runs on the CUDA card unless ``--device cpu``
is given.  ``--mesh N`` under ``torchrun --nproc_per_node N`` evaluates
data parallel (``parallel/``); rank 0 writes the files.
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

from .config import Config, parse_args
from .data.batching import Loader
from .data.dataset import SequenceDataset
from .data.synthetic import synthetic_loader
from .models.dagr import graph_static_config, init_model, resolve_device
from .parallel.mesh import (end_distributed, is_main_process, process_mesh,
                            shard_batch)
from .parallel.train_step import make_optimizer, make_train_fns
from .train import loader_args, prepare_dataset
from .utils import checkpoint as ckpt
from .utils.evaluation import (calculate_bbox_metrics,
                               calculate_frame_metrics,
                               calculate_response_metrics,
                               calculate_tta_metrics)
from .utils.fps import measure_fps
from .utils.predict import collect_predictions, load_toa_values
from .utils.result import (append_fps, create_metrics_summary, save_metrics,
                           setup_directories, setup_result_file)


def evaluate(cfg: Config, loader, *, device=None, video_toa=None,
             mesh=None) -> dict:
    """Evaluates the best checkpoint under ``cfg.output_dir`` (or
    ``cfg.test_checkpoint``; a randomly initialised model if there is none)
    over ``loader``; the result files go to a new
    ``<output_dir>/test_results/<experiment>_<stamp>``.  With a ``mesh``
    every rank reads the whole batches, evaluates its block of each and
    holds the whole batch's outputs; rank 0 writes the files."""
    dev = resolve_device(device)
    main_rank = is_main_process()
    model, bc, mc = init_model(cfg, torch.Generator().manual_seed(cfg.seed),
                               dev)
    optimizer = make_optimizer(model.head.parameters(), cfg.learning_rate,
                               cfg.weight_decay, cfg.grad_clip)
    fns = make_train_fns(model, bc, mc, graph_static_config(cfg), optimizer,
                         dev, mesh=mesh)
    checkpoint_info = {"path": "<random init>", "epoch": -1}
    try:
        path = ckpt.find_best_checkpoint(cfg.output_dir, cfg.experiment_name,
                                         cfg.test_checkpoint)
        extra = ckpt.load_checkpoint(path, model, device=dev)
        checkpoint_info = {"path": str(path), "epoch": extra.get("epoch", -1)}
        print(f"loaded checkpoint {path}")
    except FileNotFoundError as e:
        print(f"warning: {e}; evaluating randomly initialised model")
    result_dir = None
    if main_rank:
        result_dir = setup_directories(cfg.output_dir, cfg.experiment_name,
                                       "test")["result_dir"]
        result_file = setup_result_file(result_dir, cfg, checkpoint_info)

    def eval_step(batch):
        return fns.eval_step(batch if mesh is None
                             else shard_batch(batch, mesh))

    def forward(batch):
        logits, valid, labels, _loss, _nv = eval_step(batch)
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
        fps = measure_fps(eval_step, loader,
                          warmup_batches=cfg.fps_warmup_batches,
                          num_batches=cfg.fps_num_batches)
    response = calculate_response_metrics(
        results["video_predictions"],
        fps=fps["fps"] if fps and fps["fps"] > 0 else 579)
    if main_rank:
        if fps:
            append_fps(result_file, fps["fps"])
        save_metrics(result_file, bbox, frame, tta, response)
        create_metrics_summary(result_dir, cfg, bbox, frame, tta, response,
                               checkpoint_info, fps)
        print(f"results saved in: {result_dir}")
    return dict(bbox=bbox, frame=frame, tta=tta, response=response, fps=fps,
                result_dir=result_dir)


def main(argv=None):
    cfg = parse_args(argv)
    args = loader_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {dev}")
    mesh = process_mesh(cfg.mesh, dev, cfg.batch_size)
    video_toa = None
    try:
        if args.in_memory:
            loader = synthetic_loader(cfg, args.val_batches,
                                      seed=cfg.seed + 10_000)
            print(f"test batches: {len(loader)} (in memory)")
        else:
            cfg = prepare_dataset(cfg)
            video_toa = load_toa_values(cfg.toa)
            test_ds = SequenceDataset(cfg, Path(cfg.dataset_directory),
                                      "val")
            loader = Loader(test_ds, cfg, shuffle=False)
            print(f"test items: {len(test_ds)}")
        try:
            return evaluate(cfg, loader, device=dev, video_toa=video_toa,
                            mesh=mesh)
        finally:
            loader.close()
    finally:
        end_distributed()


if __name__ == "__main__":
    main(sys.argv[1:])
