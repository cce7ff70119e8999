"""Where one head-training step, one scoring forward, one detection
forward, one streaming step or one detector training step spends its time
on the GPU.

    python3 -m eventad_tpu_torch.tools.profile_step [float32|bfloat16 ...]
    python3 -m eventad_tpu_torch.tools.profile_step scoring [flavour ...]
    python3 -m eventad_tpu_torch.tools.profile_step detector [flavour ...]
    python3 -m eventad_tpu_torch.tools.profile_step streaming
    python3 -m eventad_tpu_torch.tools.profile_step detector_train [dtype ...]

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

With ``scoring`` first, the bf16 scoring forward (``model_forward`` in
eval mode) in each kernel flavour named (``default``, ``base``,
``bilinear``; default ``base``): the whole forward untraced and the trace
of 3 forwards.

With ``detector`` first, the same for ``detector_forward`` in eval mode
(bf16 features) in each kernel flavour named (``default``, ``base``,
``bilinear``, ``base+bilinear``; default the first and the last): stage
times (graph, CNN, backbone, heads, decode + NMS), the whole forward
untraced, and the trace of 3 forwards.  The detector's BN running statistics
are first moved to one batch's by ten batch-statistics passes, since random
weights on the initial statistics overflow the box decode.

With ``streaming`` first, the incremental streaming step (append + score
read, ``streaming.incremental``) at the root ``bench_streaming.py``'s
operating point (batch 1, a ring of 16 384 events, chunks of 512, bf16):
the step untraced (median of 9, one synchronise each) and a trace of 10
steps, their chunks on the card before it starts;
then, untraced in the same process, the medians of 9 ``append`` calls, 9
``read_scores`` and 9 dense steps (``streaming.runner``, the whole backbone
on the ring).  Run it in a process of its own: a trace late in a process
may lose device events (``tools/trace_probe.py``).

With ``detector_train`` first, one detector training step
(``train_detector.make_detector_train_step``: the forward to the decoded
outputs, the simOTA loss, the backward through the backbone and the
ResNet, the clip, AdamW and the EMA) at the same operating point, random
weights from seed 0, in each compute dtype named (default ``float32``):
the step untraced (median of 9, one synchronise each), the peak device
memory of those steps, and a trace of 3 steps.  Run one dtype a process
where the trace must be complete.

Prints the card's name and power limit first and one JSON line per dtype or
flavour last.  Needs a CUDA device.
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
                           init_model, model_forward)
from ..models.eventad import eventad_forward
from ..models.feature_extract import extract_box_features
from ..models.resnet import cnn_branch_forward
from ..parallel.train_step import make_optimizer, make_train_fns
from .check_fused import FLAVOURS

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


def timed_ms(fn, reps=9):
    """Host-clock milliseconds of ``reps`` calls, one synchronise each."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return ts


def traced_kernels(fn, n_traced=3):
    """``(name, device ms per call of fn, launches per call)`` of every
    device operation in a ``torch.profiler`` trace of ``n_traced`` calls."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_traced):
            fn()
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
    return kernels


def device_summary(kernels, step_ms) -> dict:
    busy = sum(k[1] for k in kernels)
    top = sorted(kernels, key=lambda k: -k[1])[:10]
    return dict(
        device_busy_ms_per_step=busy,
        device_ops_per_step=sum(k[2] for k in kernels),
        device_idle_share=1.0 - busy / step_ms,
        top_kernels=[dict(name=k[0][:100], ms_per_step=k[1],
                          calls_per_step=k[2]) for k in top])


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

    train_ts = timed_ms(lambda: fns.train_step(batch, gen))
    eval_ts = timed_ms(lambda: fns.eval_step(batch))

    kernels = traced_kernels(lambda: fns.train_step(batch, gen))
    step_ms = _median(train_ts)
    return dict(
        dtype=dtype, card=smi, stage_ms=stages,
        stage_sum_ms=sum(stages.values()), train_step_ms=step_ms,
        train_step_ms_all=train_ts, eval_step_ms=_median(eval_ts),
        train_items_per_sec=cfg.batch_size / step_ms * 1e3,
        **device_summary(kernels, step_ms))


def profile_scoring(flavour: str, smi: str) -> dict:
    dev = torch.device("cuda")
    cfg = Config(batch_size=6, use_image=True, compute_dtype="bfloat16",
                 event_buckets=(16384,))
    model, bc, mc = init_model(cfg, torch.Generator().manual_seed(0), dev)
    bc = bc._replace(**FLAVOURS[flavour])
    gsc = graph_static_config(cfg)
    batch = make_synthetic_batch(cfg, seed=0, boxes_per_item=6).to(dev)

    def forward():
        return model_forward(model, batch, bc, mc, gsc)

    for _ in range(3):
        out = forward()
    if not bool(torch.isfinite(out.logits).all()):
        raise RuntimeError("the logits are not finite")
    ts = timed_ms(forward)
    batch_ms = _median(ts)
    return dict(
        flavour=flavour, dtype="bfloat16", card=smi, batch_ms=batch_ms,
        batch_ms_all=ts, **device_summary(traced_kernels(forward), batch_ms))


DETECTOR_FLAVOURS = {
    **{k: FLAVOURS[k] for k in ("default", "base", "bilinear")},
    "base+bilinear": {**FLAVOURS["base"], **FLAVOURS["bilinear"]},
}
DETECTOR_STAGES = ("graph", "cnn", "backbone", "heads", "decode_nms")


def staged_detector_forward(detector, batch, cfg, bc):
    """One detection forward, stage by stage, a synchronise after each; the
    stage seconds.  The same calls as ``detector_forward`` makes."""
    from ..models.detector import decode_detections, head_maps
    ts = []

    def lap(t0):
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
        return time.perf_counter()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        g0 = build_level0_graph(batch.pos, batch.polarity, batch.valid,
                                graph_static_config(cfg), batch.rank)
        t0 = lap(t0)
        feats, image_outs = cnn_branch_forward(
            detector.dagr.cnn, batch.image, bc.compute_dtype, outputs=True)
        t0 = lap(t0)
        outs = backbone_forward(detector.dagr.backbone, g0, feats, bc)
        t0 = lap(t0)
        maps, strides = head_maps(detector, outs, image_outs, bc)
        t0 = lap(t0)
        decode_detections(maps, strides, bc)
        lap(t0)
    return ts


def profile_detector(flavour: str, smi: str) -> dict:
    from ..models.detector import detector_forward, init_detector
    dev = torch.device("cuda")
    cfg = Config(batch_size=6, use_image=True, compute_dtype="bfloat16",
                 event_buckets=(16384,))
    detector, bc = init_detector(cfg, torch.Generator().manual_seed(0), dev)
    batch = make_synthetic_batch(cfg, seed=0, boxes_per_item=6).to(dev)
    with torch.no_grad():
        for _ in range(10):
            detector_forward(detector, batch, cfg,
                             bc._replace(compute_dtype="float32"),
                             training=True)
    bc = bc._replace(**DETECTOR_FLAVOURS[flavour])

    def forward():
        return detector_forward(detector, batch, cfg, bc)

    for _ in range(3):
        _, decoded = forward()
    if not bool(torch.isfinite(decoded).all()):
        raise RuntimeError("the decoded outputs are not finite")
    stage_runs = [staged_detector_forward(detector, batch, cfg, bc)
                  for _ in range(7)]
    stages = {name: _median([r[i] for r in stage_runs]) * 1e3
              for i, name in enumerate(DETECTOR_STAGES)}
    ts = timed_ms(forward)
    batch_ms = _median(ts)
    return dict(
        flavour=flavour, dtype="bfloat16", card=smi, stage_ms=stages,
        stage_sum_ms=sum(stages.values()), batch_ms=batch_ms,
        batch_ms_all=ts, images_per_sec=cfg.batch_size / batch_ms * 1e3,
        **device_summary(traced_kernels(forward), batch_ms))


def profile_streaming(smi: str, n_traced: int = 10) -> dict:
    """The streaming mode (see the module docstring)."""
    from ..streaming import incremental as inc
    from ..streaming.evaluate import SyntheticStream, bench_boxes
    from ..streaming.runner import (insert_events, make_stream_step,
                                    update_image)
    from ..streaming.state import init_streaming_state
    dev = torch.device("cuda")
    n_buf, n_chunk = 16384, 512
    cfg = Config(batch_size=1, use_image=True, compute_dtype="bfloat16",
                 event_buckets=(n_buf,))
    model, bc, mc = init_model(cfg, torch.Generator().manual_seed(0), dev)
    refresh, step = inc.make_incremental_step(
        model, bc, mc, graph_static_config(cfg), n_chunk=n_chunk,
        n_buf=n_buf)
    ev = SyntheticStream(cfg, n_chunk, 0, dev)
    st = inc.update_image(model, inc.init_incremental_state(
        n_buf, bc, mc, device=dev), ev.image())
    ones = torch.ones((n_chunk,), device=dev)
    for _ in range(n_buf // n_chunk):
        st = inc.insert_raw(st, ev.chunk(), ones, n_chunk)
    st = refresh(st)
    boxes, present = bench_boxes(cfg, 4, dev)
    chunks = [ev.chunk() for _ in range(3 + 9 + n_traced)]

    def one_step():
        nonlocal st
        st, logits = step(st, chunks.pop(0), ones, n_chunk, boxes, present)
        return logits

    for _ in range(3):
        logits = one_step()
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("the logits are not finite")
    ts = timed_ms(one_step)
    step_ms = _median(ts)
    device = device_summary(traced_kernels(one_step, n_traced), step_ms)

    # untraced, the parts and the dense step beside it; every timed call
    # takes a chunk made before the clock starts
    more = [ev.chunk() for _ in range(9)]

    def one_append():
        nonlocal st
        st = step.append(st, more.pop(0), ones, n_chunk)
    append_ms = _median(timed_ms(one_append))
    read_ms = _median(timed_ms(lambda: step.read_scores(st, boxes,
                                                        present)))
    sst = update_image(model, init_streaming_state(
        n_buf, cfg.max_boxes, cfg.h_dim, device=dev), ev.image())
    for _ in range(n_buf // n_chunk):
        sst = insert_events(sst, ev.chunk(), ones, n_chunk)
    dense_step = make_stream_step(model, bc, mc, graph_static_config(cfg),
                                  n_chunk=n_chunk)
    more = [ev.chunk() for _ in range(3 + 9)]

    def one_dense():
        nonlocal sst
        sst, logits = dense_step(sst, more.pop(0), ones, n_chunk, boxes,
                                 present)
        return logits
    for _ in range(3):
        one_dense()
    dense_ms = _median(timed_ms(one_dense))
    return dict(mode="streaming", dtype="bfloat16", card=smi,
                n_buf=n_buf, events_per_chunk=n_chunk, step_ms=step_ms,
                step_ms_all=ts, n_traced=n_traced, append_ms=append_ms,
                read_scores_ms=read_ms, dense_step_ms=dense_ms, **device)


def profile_detector_train(dtype: str, smi: str) -> dict:
    """The ``detector_train`` mode (see the module docstring)."""
    from ..models.detector import init_detector
    from ..train_detector import anchor_geometry, make_detector_train_step
    from ..utils.ema import ema_init
    from ..utils.schedules import make_detector_optimizer, yolox_schedule
    dev = torch.device("cuda")
    cfg = Config(batch_size=6, use_image=True, compute_dtype=dtype,
                 event_buckets=(16384,))
    detector, bc = init_detector(cfg, torch.Generator().manual_seed(0), dev)
    optimizer = make_detector_optimizer(
        detector.parameters(), cfg.optimizer,
        yolox_schedule(cfg.lr, warmup_steps=1, total_steps=1000),
        cfg.weight_decay, cfg.clip)
    step = make_detector_train_step(detector, cfg, bc, optimizer,
                                    anchor_geometry(bc, dev))
    batch = make_synthetic_batch(cfg, seed=0, boxes_per_item=6).to(dev)
    ema = ema_init(detector.parameters())

    def one_step():
        nonlocal ema
        ema, losses = step(batch, ema)
        return losses

    for _ in range(3):
        losses = one_step()
    if not bool(torch.isfinite(losses["total"])):
        raise RuntimeError("the loss is not finite")
    torch.cuda.reset_peak_memory_stats()
    ts = timed_ms(one_step)
    peak = torch.cuda.max_memory_allocated()
    step_ms = _median(ts)
    return dict(
        mode="detector_train", dtype=dtype, card=smi, step_ms=step_ms,
        step_ms_all=ts, items_per_sec=cfg.batch_size / step_ms * 1e3,
        peak_memory_bytes=peak,
        **device_summary(traced_kernels(one_step), step_ms))


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    argv = list(argv or [])
    if argv[:1] == ["scoring"]:
        for flavour in argv[1:] or ["base"]:
            print(json.dumps(profile_scoring(flavour, smi)), flush=True)
        return
    if argv[:1] == ["streaming"]:
        print(json.dumps(profile_streaming(smi)), flush=True)
        return
    if argv[:1] == ["detector_train"]:
        for dtype in argv[1:] or ["float32"]:
            print(json.dumps(profile_detector_train(dtype, smi)), flush=True)
        return
    if argv[:1] == ["detector"]:
        for flavour in argv[1:] or ["default", "base+bilinear"]:
            print(json.dumps(profile_detector(flavour, smi)), flush=True)
        return
    for dtype in argv or ["float32", "bfloat16"]:
        print(json.dumps(profile_dtype(dtype, smi)), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
