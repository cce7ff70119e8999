"""Where one head-training step spends its time on the GPU.

    python3 -m eventad_tpu_torch.tools.profile_step [float32|bfloat16 ...]

At the reference operating point (batch 6, 360x240, 16 384 events per item,
ResNet-50, random weights from seed 0), for each compute dtype named
(default both):

* stage times: host-clock medians over 7 steps with a device synchronise
  after each stage (graph, CNN, backbone, box features, head forward, head
  backward, guard + clip + AdamW);
* the whole ``train_step`` and ``eval_step``, untraced, median of 9, one
  synchronise per step;
* a ``torch.profiler`` trace of 3 train steps: device-busy time and the
  number of device operations per step, the idle share of the untraced
  step, and the ten kernels with the most device time.

Prints the card's name and power limit first and one JSON line per dtype
last.  Needs a CUDA device.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from ..config import Config
from ..data.synthetic import make_synthetic_batch
from ..models.backbone import backbone_forward
from ..models.dagr import (build_level0_graph, graph_static_config,
                           init_model)
from ..models.eventad import eventad_forward
from ..models.feature_extract import extract_box_features
from ..models.resnet import cnn_branch_forward
from ..parallel.train_step import make_optimizer, make_train_fns

STAGES = ("graph", "cnn", "backbone", "box_features", "head_forward",
          "head_backward", "guard_clip_adamw")


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def staged_step(model, batch, bc, mc, gsc, optimizer):
    """One train step, stage by stage, a synchronise after each; returns
    the stage seconds.  The same calls as ``model_forward`` and
    ``train_step`` make."""
    ts = []

    def lap(t0):
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
        return time.perf_counter()

    optimizer.zero_grad()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        g0 = build_level0_graph(batch.pos, batch.polarity, batch.valid, gsc,
                                batch.rank)
        t0 = lap(t0)
        feats = (cnn_branch_forward(model.dagr.cnn, batch.image,
                                    bc.compute_dtype)
                 if bc.use_image else None)
        t0 = lap(t0)
        _, out4 = backbone_forward(model.dagr.backbone, g0, feats, bc)
        t0 = lap(t0)
        box = extract_box_features(out4, batch.boxes, batch.box_present,
                                   bc.batch_size, bc.width, bc.height)
        box = box.to(torch.float32)
        denom = torch.tensor([bc.width, bc.height, bc.width, bc.height],
                             dtype=torch.float32, device=box.device)
        coords = batch.boxes[:, 1] / denom
        t0 = lap(t0)
    out = eventad_forward(model.head, mc, box, coords,
                          batch.box_present[:, 1], batch.box_labels,
                          training=True)
    t0 = lap(t0)
    out.loss.backward()
    t0 = lap(t0)
    flags = [torch.isfinite(out.loss)] + [
        torch.isfinite(p.grad).all() for p in model.head.parameters()]
    if bool(torch.stack(flags).all()):
        optimizer.step()
    lap(t0)
    return ts


def profile_dtype(dtype: str, smi: str) -> dict:
    dev = torch.device("cuda")
    cfg = Config(batch_size=6, use_image=True, compute_dtype=dtype,
                 event_buckets=(16384,))
    model, bc, mc = init_model(cfg, torch.Generator().manual_seed(0), dev)
    gsc = graph_static_config(cfg)
    optimizer = make_optimizer(model.head.parameters(), cfg.learning_rate,
                               cfg.weight_decay, cfg.grad_clip)
    fns = make_train_fns(model, bc, mc, gsc, optimizer)
    batch = make_synthetic_batch(cfg, seed=0, boxes_per_item=6).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)

    for _ in range(3):
        fns.train_step(batch, gen)
    torch.cuda.synchronize()
    stage_runs = [staged_step(model, batch, bc, mc, gsc, optimizer)
                  for _ in range(7)]
    stages = {name: _median([r[i] for r in stage_runs]) * 1e3
              for i, name in enumerate(STAGES)}

    def timed(fn, reps=9):
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return ts

    train_ts = timed(lambda: fns.train_step(batch, gen))
    eval_ts = timed(lambda: fns.eval_step(batch))

    from torch.profiler import ProfilerActivity, profile
    n_traced = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_traced):
            fns.train_step(batch, gen)
        torch.cuda.synchronize()
    kernels = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        # device-side spans of host annotations (the optimizer's
        # record_function) are not device work
        if us > 0 and str(e.device_type).endswith("CUDA") \
                and not getattr(e, "is_user_annotation", False) \
                and not e.key.startswith(("Optimizer.", "ProfilerStep")):
            kernels.append((e.key, us / 1e3 / n_traced, e.count / n_traced))
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    busy = sum(k[1] for k in kernels)
    step_ms = _median(train_ts)
    top = sorted(kernels, key=lambda k: -k[1])[:10]
    return dict(
        dtype=dtype, card=smi, stage_ms=stages,
        stage_sum_ms=sum(stages.values()), train_step_ms=step_ms,
        train_step_ms_all=train_ts, eval_step_ms=_median(eval_ts),
        train_items_per_sec=cfg.batch_size / step_ms * 1e3,
        device_busy_ms_per_step=busy,
        device_ops_per_step=sum(k[2] for k in kernels),
        device_idle_share=1.0 - busy / step_ms,
        top_kernels=[dict(name=k[0][:100], ms_per_step=k[1],
                          calls_per_step=k[2]) for k in top])


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    for dtype in argv or ["float32", "bfloat16"]:
        print(json.dumps(profile_dtype(dtype, smi)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
