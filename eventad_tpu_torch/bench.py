"""Headline benchmark of the port: batched inference throughput of the whole
EventAD pipeline at the reference operating point (360x240, batch 6,
16 384 events per item, ResNet-50 image branch, bf16 frozen features,
weights from seed 0, 6 boxes per item), counted as the reference's FPS
harness counts it: bounding boxes per second (counterpart of the root
``bench.py``).

    python -m eventad_tpu_torch.bench [n_events] [compute_dtype] [--device cpu]

Prints the card's name and power limit, then JSON lines, each a superset of
the one before:

1. the headline (``metric``, ``value``, ``unit``, ``vs_baseline`` against
   the reference's 595.48 bboxes/s, ``batch_ms``, the pipelined figures,
   ``frames_per_sec``, ``events_per_item``, ``device``, ``power_limit_w``);
2. the model's analytic counts (``model_gflops_per_batch``,
   ``model_gbytes_min_per_batch``, ``utils/roofline.forward_roofline``)
   and, on the card, the device-true time of a forward: under the JAX
   bench's ``scan_`` names, which there mean a program of n forwards, here
   CUDA-graph replay (``utils/devtime``: the forward captured once after
   the warm-up, replayed 10 and 50 times, the difference per replay):
   ``scan_device_ms_per_batch``, ``scan_bboxes_per_sec``,
   ``scan_vs_baseline``, ``est_rtt_ms`` (``batch_ms`` less that time: the
   host's share), and the roofline over it (``mfu``, ``mfu_peak_tflops``,
   ``hbm_gbps_min``, ``roofline_bound_ms``, ``roofline_warning`` if a rate
   is impossible);
3. on the card, ``trace_device_ms_per_batch``: the union of the device
   intervals of one replay of the captured forward in a ``torch.profiler``
   trace taken right after the capture's warm-up, the process's first
   trace (``utils/devtime.trace_device_ms``).  It traces the captured
   forward, the one the scan time replays: the same forward run eagerly
   keeps the card busier (its kernels' intervals sum to a few per cent
   more), and the profiler itself lengthens each kernel slightly;
4. the head-training figure (``train_items_per_sec``,
   ``train_ms_per_batch``, ``train_compute_dtype``).

Timing: 5 warm-up forwards, 20 with one synchronise each (their median),
then 20 enqueued and one synchronise; training 2 warm-up steps, then 10 on
one batch and one synchronise; then, on the card, the capture (5 warm-up
forwards), the trace and the replays.  The first record is printed as
soon as it is measured, the others at the end.  Any failure ends the run with a non-zero
code.  Other ``Config`` fields (``--width``, ``--batch_size``, ...) may be
given; runs on the CUDA card unless ``--device cpu`` is given, and without
a card and without that flag it raises.  Not ported from the root script:
the ``xla_*`` keys (XLA's cost model) and the ``EVENTAD_BENCH_*`` time
budgets.
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
from .utils.devtime import capture, replay_ms, trace_device_ms
from .utils.roofline import forward_roofline, roofline_rates

BASELINE_FPS = 595.48      # reference committed run (BASELINE.md)
BOXES_PER_ITEM = 6
WARMUP, ITERS = 5, 20
TRAIN_WARMUP, TRAIN_ITERS = 2, 10
TRACE_ITERS = 6


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def count_boxes(batch) -> int:
    """Boxes per batch, counted like the reference (bbox + bbox0)."""
    return int(batch.bbox_mask.sum()) + int(batch.bbox0_mask.sum())


def scoring_forward(model, batch, bc, mc, gsc):
    """The benched call: ``model_forward`` on ``batch`` without gradients,
    returning the logits."""
    def fwd():
        with torch.no_grad():
            return model_forward(model, batch, bc, mc, gsc).logits
    return fwd


def headline(model, batch, cfg: Config, bc, mc, gsc) -> dict:
    """The inference record of ``model`` on ``batch`` (on the model's
    device): sync bboxes/s from the median of ``ITERS`` synchronised
    forwards after ``WARMUP``, pipelined from ``ITERS`` enqueued ones."""
    dev = batch.pos.device
    fwd = scoring_forward(model, batch, bc, mc, gsc)
    n_boxes = count_boxes(batch)
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


def device_records(graph, batch, cfg: Config, roof: dict,
                   batch_ms: float) -> dict:
    """The card's own time for a forward (a replay of its capture
    ``graph``), its share of ``batch_ms`` and the roofline ``roof`` over it
    (the second record's card keys)."""
    scan_ms = replay_ms(graph)
    bps = count_boxes(batch) / scan_ms * 1e3
    out = {"scan_device_ms_per_batch": scan_ms,
           "scan_bboxes_per_sec": bps,
           "scan_vs_baseline": bps / BASELINE_FPS,
           "est_rtt_ms": max(batch_ms - scan_ms, 0.0)}
    out.update(roofline_rates(
        roof, scan_ms / 1e3, torch.cuda.get_device_name(batch.pos.device),
        cfg.compute_dtype))
    return out


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
    """Prints the records of ``model`` on ``batch`` (see the module
    docstring) and returns the last (``card``: ``nvidia-smi``'s name and
    power limit, or "cpu").  The headline and the training figure are
    measured first, so that no host-clock figure runs after a profiler
    trace or beside a held graph."""
    dev = batch.pos.device
    on_card = dev.type == "cuda"
    result = headline(model, batch, cfg, bc, mc, gsc)
    result["device"] = torch.cuda.get_device_name(dev) if on_card else "cpu"
    result["power_limit_w"] = (float(card.split(",")[-1].split()[0])
                               if on_card else None)
    print(json.dumps(result), flush=True)
    training = training_figure(model, batch, cfg, bc, mc, gsc)
    roof = forward_roofline(cfg, int(batch.pos.shape[1]))
    result["model_gflops_per_batch"] = roof["flops"] / 1e9
    result["model_gbytes_min_per_batch"] = roof["bytes"] / 1e9
    records = []
    if on_card:
        # one capture for the trace and the replay time (a capture's time
        # can differ from another's); the trace right after the capture's
        # warm-up, the process's first: late traces lose device events
        graph, _ = capture(scoring_forward(model, batch, bc, mc, gsc),
                           warmup=WARMUP)
        trace_ms = trace_device_ms(graph.replay, iters=TRACE_ITERS)
        result.update(device_records(graph, batch, cfg, roof,
                                     result["batch_ms"]))
        del graph
        records.append(dict(result))
        result["trace_device_ms_per_batch"] = trace_ms
    records.append(dict(result))
    result.update(training)
    for r in records + [result]:
        print(json.dumps(r), flush=True)
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
