"""Headline benchmark of the port: batched inference throughput of the whole
EventAD pipeline at the reference operating point (360x240, batch 6,
16 384 events per item, ResNet-50 image branch, bf16 frozen features,
weights from seed 0, 6 boxes per item), counted as the reference's FPS
harness counts it: bounding boxes per second (counterpart of the root
``bench.py``).

    python -m eventad_tpu_torch.bench [n_events] [compute_dtype] [--device cpu]

Prints the card's name and power limit, then two JSON lines: the headline
(``metric``, ``value``, ``unit``, ``vs_baseline`` against the reference's
595.48 bboxes/s, ``batch_ms``, the pipelined figures, ``frames_per_sec``,
``events_per_item``, ``device``, ``power_limit_w``), then the same record
with the head-training figure added (``train_items_per_sec``,
``train_ms_per_batch``, ``train_compute_dtype``).  Timing: 5 warm-up
forwards, 20 with one synchronise each (their median), then 20 enqueued
and one synchronise; training 2 warm-up steps, then 10 on one batch and
one synchronise.  Any failure ends the run with a non-zero code.  Other
``Config`` fields (``--width``, ``--batch_size``, ...) may be given; runs
on the CUDA card unless ``--device cpu`` is given, and without a card and
without that flag it raises.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

from .bench_detector import card_name_and_limit
from .config import Config, parse_args
from .data.synthetic import make_synthetic_batch
from .models.dagr import (graph_static_config, init_model, model_forward,
                          resolve_device)
from .parallel.train_step import make_optimizer, make_train_fns

BASELINE_FPS = 595.48      # reference committed run (BASELINE.md)
BOXES_PER_ITEM = 6
WARMUP, ITERS = 5, 20
TRAIN_WARMUP, TRAIN_ITERS = 2, 10


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def headline(model, batch, cfg: Config, bc, mc, gsc) -> dict:
    """The inference record of ``model`` on ``batch`` (on the model's
    device): sync bboxes/s from the median of ``ITERS`` synchronised
    forwards after ``WARMUP``, pipelined from ``ITERS`` enqueued ones."""
    dev = batch.pos.device

    def fwd():
        with torch.no_grad():
            return model_forward(model, batch, bc, mc, gsc).logits

    # boxes per batch, counted like the reference (bbox + bbox0)
    n_boxes = int(batch.bbox_mask.sum()) + int(batch.bbox0_mask.sum())
    for _ in range(WARMUP):
        fwd()
    _sync(dev)
    ts = []
    for _ in range(ITERS):
        t0 = time.perf_counter()
        fwd()
        _sync(dev)
        ts.append(time.perf_counter() - t0)
    dt = statistics.median(ts)
    t0 = time.perf_counter()
    for _ in range(ITERS):
        fwd()
    _sync(dev)
    dt_pipe = (time.perf_counter() - t0) / ITERS
    fps = n_boxes / dt
    return {
        "metric": "inference_bboxes_per_sec",
        "value": fps,
        "unit": "bboxes/s",
        "vs_baseline": fps / BASELINE_FPS,
        "batch_ms": dt * 1e3,
        "pipelined_bboxes_per_sec": n_boxes / dt_pipe,
        "pipelined_vs_baseline": n_boxes / dt_pipe / BASELINE_FPS,
        "pipelined_ms_per_batch": dt_pipe * 1e3,
        "frames_per_sec": cfg.batch_size / dt,
        "events_per_item": int(batch.pos.shape[1]),
    }


def training_figure(model, batch, cfg: Config, bc, mc, gsc) -> dict:
    """Head training on ``batch``: ``TRAIN_WARMUP`` steps, then
    ``TRAIN_ITERS`` with one synchronise (a fresh optimizer, dropout from
    a generator seeded 0; the head's weights move)."""
    dev = batch.pos.device
    opt = make_optimizer(model.head.parameters(), cfg.learning_rate,
                         cfg.weight_decay, cfg.grad_clip)
    fns = make_train_fns(model, bc, mc, gsc, opt, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    for _ in range(TRAIN_WARMUP):
        fns.train_step(batch, gen)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(TRAIN_ITERS):
        fns.train_step(batch, gen)
    _sync(dev)
    dt = (time.perf_counter() - t0) / TRAIN_ITERS
    return {"train_items_per_sec": cfg.batch_size / dt,
            "train_ms_per_batch": dt * 1e3,
            "train_compute_dtype": cfg.compute_dtype}


def run(model, batch, cfg: Config, bc, mc, gsc, card: str) -> dict:
    """Prints the headline record of ``model`` on ``batch``, then that
    record with the training figure added, and returns the latter
    (``card``: ``nvidia-smi``'s name and power limit, or "cpu")."""
    dev = batch.pos.device
    result = headline(model, batch, cfg, bc, mc, gsc)
    result["device"] = (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu")
    result["power_limit_w"] = (float(card.split(",")[-1].split()[0])
                               if dev.type == "cuda" else None)
    print(json.dumps(result), flush=True)
    result.update(training_figure(model, batch, cfg, bc, mc, gsc))
    print(json.dumps(result), flush=True)
    return result


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n_events", nargs="?", type=int, default=16384)
    p.add_argument("compute_dtype", nargs="?", default="bfloat16")
    p.add_argument("--device", default=None)
    args, rest = p.parse_known_args(argv)
    dev = resolve_device(args.device)
    card = card_name_and_limit() if dev.type == "cuda" else "cpu"
    print(card, flush=True)
    cfg = parse_args(rest).replace(compute_dtype=args.compute_dtype,
                                   event_buckets=(args.n_events,))
    model, bc, mc = init_model(cfg, torch.Generator().manual_seed(0), dev)
    gsc = graph_static_config(cfg)
    batch = make_synthetic_batch(cfg, boxes_per_item=BOXES_PER_ITEM).to(dev)
    return run(model, batch, cfg, bc, mc, gsc, card)


if __name__ == "__main__":
    main()
