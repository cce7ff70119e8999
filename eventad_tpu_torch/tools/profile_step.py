"""Where one head-training step, one scoring batch, one detection forward,
one streaming step or one detector training step spends its time, stage by
stage, on the host and on the GPU.

    python3 -m eventad_tpu_torch.tools.profile_step [float32|bfloat16 ...]
    python3 -m eventad_tpu_torch.tools.profile_step scoring [flavour ...]
    python3 -m eventad_tpu_torch.tools.profile_step detector [flavour ...]
    python3 -m eventad_tpu_torch.tools.profile_step streaming
    python3 -m eventad_tpu_torch.tools.profile_step detector_train [dtype ...]

Each mode warms its call up, times it untraced (host clock, one synchronise
a call), then traces ``n_traced`` calls in one ``torch.profiler`` session,
each call in a range of its own.  Only a process's first trace keeps every
device event (``PERF.md`` §6, PRs 1-12), so run one mode, dtype or flavour
a process where the trace must be whole.  From the trace:

* the card: device operations (kernels, copies, sets) and busy
  milliseconds per call, busy being the union of their intervals (the
  arithmetic of ``utils/devtime.trace_device_ms``); the idle share of the
  traced window (the first call's start to the last call's end or the last
  device operation's, whichever is later); the ten device operations that
  took most time;
* the stages, one row per program span (``utils/spans``: name and parent)
  with, per call: its calls, its host self milliseconds from the program's
  own summary, the device operations it launched (each joined to its
  launching runtime call by the profiler's correlation id, and so to the
  innermost span open at the launch) and their busy milliseconds, and its
  host-blocking runtime calls (stream, device and event synchronisations,
  ``cudaMemcpy``, copies from pageable memory) with their milliseconds.
  Work outside every span is the row "outside program spans"; a device
  operation whose runtime call is not in the trace is counted as
  ``unjoined_device_ops``;
* the ten longest idle gaps of the card, each named by the innermost
  program span the host was in at the gap's middle (``runtime/gc`` is a
  garbage collection).

Modes, at the reference operating point (batch 6, 360x240, ResNet-50,
random weights from seed 0):

* no mode word: ``train_step`` (the frozen features, the head's forward and
  backward, guard, clip, AdamW) in each compute dtype named (default both),
  and ``eval_step`` untraced; 3 steps traced.
* ``scoring``: one scoring batch as the benchmark's ``rol.score`` cell
  runs it: the next batch from the serial ``Loader`` over a
  ``MemoryDataset`` of moving-edge sequences (``data/fixtures.
  make_sequence``, 6 objects, items of about 15 000 events), the copy to
  the card, ``model_forward`` in eval mode and the logits back on the host;
  bf16 features in each kernel flavour named (``default``, ``base``,
  ``bilinear``; default ``default``, the path the cell runs); 12 batches
  traced.
* ``detector``: ``detector_forward`` in eval mode (bf16 features) on one
  synthetic batch in each kernel flavour named (``default``, ``base``,
  ``bilinear``, ``base+bilinear``; default the first and the last); the
  BN running statistics first moved to the batch's by ten batch-statistics
  passes (random weights on the initial statistics overflow the box
  decode); 3 forwards traced.
* ``streaming``: the incremental step (``append`` + ``read_scores``) at the
  streaming bench's operating point (batch 1, a ring of 16 384 events,
  chunks of 512, bf16), its chunks on the card before the clock starts; 10
  steps traced; then, untraced, the medians of 9 ``append`` calls, 9
  ``read_scores`` and 9 dense steps (``streaming.runner``, the whole
  backbone on the ring).
* ``detector_train``: one detector training step (``train_detector.
  make_detector_train_step``: the forward, the simOTA loss, the backward
  through the backbone and the ResNet, clip, AdamW, EMA) in each dtype
  named (default ``float32``), with the peak device memory of the timed
  steps; 3 steps traced.

Prints the card's name and power limit first and one JSON line per dtype or
flavour last.  Needs a CUDA device.
"""
from __future__ import annotations

import bisect
import json
import subprocess
import sys
import time

import torch

from ..config import Config
from ..data.synthetic import make_synthetic_batch
from ..models.dagr import graph_static_config, init_model, model_forward
from ..parallel.train_step import make_optimizer, make_train_fns
from ..utils import spans
from ..utils.devtime import union_intervals
from .check_fused import FLAVOURS

CALL = "profile_step/call"
# device-side ranges of host annotations, not device work
ANNOTATIONS = ("Optimizer.", "ProfilerStep", spans.PREFIX, CALL)
# runtime calls that hold the host until the card has caught up
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")
OUTSIDE = "outside program spans"


def _median(xs):
    return sorted(xs)[len(xs) // 2]


def timed_ms(fn, reps=9):
    """Host-clock milliseconds of ``reps`` calls, one synchronise each."""
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return ts


def traced(fn, n_traced=3):
    """``(events, summary)``: the events of one ``torch.profiler`` session
    over ``n_traced`` calls of ``fn``, each in a range of its own, and the
    program's span summary of that session."""
    from torch.profiler import ProfilerActivity, profile, record_function
    spans.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_traced):
            with record_function(CALL):
                fn()
        torch.cuda.synchronize()
    summary = spans.summary()
    spans.reset()
    return prof.events(), summary


def _is_device(e) -> bool:
    return str(e.device_type).endswith("CUDA")


def device_ops(events) -> list:
    """The trace's device operations: kernels, copies and sets, without
    the device-side ranges of host annotations."""
    ops = [e for e in events if _is_device(e)
           and not getattr(e, "is_user_annotation", False)
           and not e.name.startswith(ANNOTATIONS)]
    if not ops:
        raise RuntimeError("the profiler recorded no device time")
    return ops


def kernel_table(ops, n_traced) -> list:
    """``(name, device ms per call, launches per call)`` of every device
    operation name."""
    by = {}
    for e in ops:
        t = by.setdefault(e.name, [0.0, 0])
        t[0] += e.time_range.end - e.time_range.start
        t[1] += 1
    return [(k, us / 1e3 / n_traced, c / n_traced)
            for k, (us, c) in by.items()]


def traced_kernels(fn, n_traced=3):
    """``(name, device ms per call of fn, launches per call)`` of every
    device operation in a trace of ``n_traced`` calls."""
    return kernel_table(device_ops(traced(fn, n_traced)[0]), n_traced)


class _Spans:
    """The program's spans of one thread in a trace, nested: the innermost
    span open at a time, with its parent's name."""

    def __init__(self, evs):
        evs = sorted(evs, key=lambda e: (e[0], -e[1]))
        self.evs, self.parent, stack = evs, [], []
        for i, (s, _, _) in enumerate(evs):
            while stack and evs[stack[-1]][1] < s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)
        self.starts = [e[0] for e in evs]

    def at(self, t):
        """``(name, parent)`` of the innermost span open at ``t``, or
        ``(OUTSIDE, None)``."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.evs[i][1] < t:
            i = self.parent[i]
        if i < 0:
            return OUTSIDE, None
        up = self.parent[i]
        return self.evs[i][2], (self.evs[up][2] if up >= 0 else None)


def device_summary(events, n_traced, summary) -> dict:
    """The card's figures, the stages and the idle gaps of a trace of
    ``n_traced`` calls (see the module docstring)."""
    n = n_traced
    ops = device_ops(events)
    host = [e for e in events if not _is_device(e)]
    calls = [e.time_range for e in host if e.name == CALL]
    if len(calls) != n:
        raise RuntimeError(f"{len(calls)} call ranges in the trace, {n} "
                           f"calls made")
    main = next(e.thread for e in host if e.name == CALL)
    w0 = min(r.start for r in calls)
    w1 = max(max(r.end for r in calls), max(e.time_range.end for e in ops))
    busy = union_intervals((e.time_range.start, e.time_range.end)
                           for e in ops)
    busy_us = sum(e - s for s, e in busy)

    by_thread = {}
    for e in host:
        if e.name.startswith(spans.PREFIX):
            by_thread.setdefault(e.thread, []).append(
                (e.time_range.start, e.time_range.end,
                 e.name[len(spans.PREFIX):]))
    nests = {th: _Spans(evs) for th, evs in by_thread.items()}
    empty = _Spans([])

    def stage_at(t, thread):
        return nests.get(thread, nests.get(main, empty)).at(t)

    rows = {}

    def row(key):
        return rows.setdefault(key, {"ops": [], "blocking": 0,
                                     "blocking_us": 0.0})

    runtime = {e.id: e for e in host if e.name.startswith("cu")}
    unjoined = 0
    for op in ops:
        rt = runtime.get(op.id)
        if rt is None:
            unjoined += 1
            continue
        row(stage_at(rt.time_range.start, rt.thread))["ops"].append(
            (op.time_range.start, op.time_range.end))
    op_name = {op.id: op.name for op in ops}
    for rt in runtime.values():
        if rt.name in SYNCS or (rt.name.startswith("cudaMemcpy")
                                and "Pageable" in op_name.get(rt.id, "")):
            r = row(stage_at(rt.time_range.start, rt.thread))
            r["blocking"] += 1
            r["blocking_us"] += rt.time_range.end - rt.time_range.start

    own = {}
    for r in summary["spans"]:
        own[(r["name"], r["parent"])] = r
        row((r["name"], r["parent"]))
    stages = []
    for (name, parent), r in rows.items():
        o = own.get((name, parent), {})
        stages.append(dict(
            name=name, parent=parent, calls=o.get("calls", 0) / n,
            host_self_ms=o.get("self_ms", 0.0) / n,
            device_ops=len(r["ops"]) / n,
            device_busy_ms=sum(e - s for s, e in union_intervals(r["ops"]))
            / 1e3 / n,
            blocking_calls=r["blocking"] / n,
            blocking_ms=r["blocking_us"] / 1e3 / n))
    stages.sort(key=lambda d: -(d["host_self_ms"] + d["blocking_ms"]))

    gaps = []
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        if s1 > e0:
            gaps.append((s1 - e0, stage_at((e0 + s1) / 2, main)[0]))
    gaps.sort(reverse=True)
    top = sorted(kernel_table(ops, n), key=lambda k: -k[1])[:10]
    window_us = w1 - w0
    return dict(
        device_busy_ms_per_step=busy_us / 1e3 / n,
        device_ops_per_step=len(ops) / n,
        device_idle_share=1.0 - busy_us / window_us,
        traced_window_ms_per_step=window_us / 1e3 / n,
        top_kernels=[dict(name=k[0][:100], ms_per_step=k[1],
                          calls_per_step=k[2]) for k in top],
        stages=stages, unjoined_device_ops=unjoined / n,
        idle_gaps=[dict(span=name, ms=g / 1e3) for g, name in gaps[:10]],
        program_units=summary["units"],
        counters_per_step={k: v / n for k, v in
                           summary["counters"].items()})


def profile_calls(fn, n_traced=3) -> dict:
    """``n_traced`` and :func:`device_summary` of a trace of ``n_traced``
    calls of ``fn``."""
    events, summary = traced(fn, n_traced)
    return dict(n_traced=n_traced,
                **device_summary(events, n_traced, summary))


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
    train_ts = timed_ms(lambda: fns.train_step(batch, gen))
    eval_ts = timed_ms(lambda: fns.eval_step(batch))
    step_ms = _median(train_ts)
    return dict(
        dtype=dtype, card=smi, train_step_ms=step_ms,
        train_step_ms_all=train_ts, eval_step_ms=_median(eval_ts),
        train_items_per_sec=cfg.batch_size / step_ms * 1e3,
        **profile_calls(lambda: fns.train_step(batch, gen)))


def scoring_batches(cfg: Config, n_sequences: int = 8, seed: int = 0):
    """Endless batches of the serial ``Loader`` over a ``MemoryDataset`` of
    moving-edge sequences at ``cfg``'s model size (6 objects, every third
    sequence anomalous, about 15 000 events a frame pair), shuffled."""
    from ..data.batching import Loader
    from ..data.dataset import MemoryDataset
    from ..data.fixtures import make_sequence
    seqs = [make_sequence(f"seq{i:03d}", cfg, n_frames=12, n_objects=6,
                          anomalous=i % 3 == 0, seed=seed + i,
                          events_per_window=15000, frame_scale=1)
            for i in range(n_sequences)]
    loader = Loader(MemoryDataset(cfg, seqs), cfg, shuffle=True, seed=seed,
                    prefetch=0, num_workers=0)
    while True:
        yield from loader


def profile_scoring(flavour: str, smi: str, n_traced: int = 12) -> dict:
    dev = torch.device("cuda")
    cfg = Config(batch_size=6, use_image=True, compute_dtype="bfloat16")
    model, bc, mc = init_model(cfg, torch.Generator().manual_seed(0), dev)
    bc = bc._replace(**FLAVOURS[flavour])
    gsc = graph_static_config(cfg)
    feed = scoring_batches(cfg)

    def one_batch():
        batch, _ = next(feed)
        with torch.no_grad():
            return model_forward(model, batch.to(dev), bc, mc,
                                 gsc).logits.cpu()

    # two epochs of the dataset: every bucket the items reach
    for _ in range(30):
        logits = one_batch()
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("the logits are not finite")
    ts = timed_ms(one_batch)
    batch_ms = _median(ts)
    return dict(
        flavour=flavour, dtype="bfloat16", card=smi, batch_ms=batch_ms,
        step_ms=batch_ms, batch_ms_all=ts,
        **profile_calls(one_batch, n_traced))


DETECTOR_FLAVOURS = {
    **{k: FLAVOURS[k] for k in ("default", "base", "bilinear")},
    "base+bilinear": {**FLAVOURS["base"], **FLAVOURS["bilinear"]},
}


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
    ts = timed_ms(forward)
    batch_ms = _median(ts)
    return dict(
        flavour=flavour, dtype="bfloat16", card=smi, batch_ms=batch_ms,
        batch_ms_all=ts, images_per_sec=cfg.batch_size / batch_ms * 1e3,
        **profile_calls(forward))


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
    device = profile_calls(one_step, n_traced)

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
                step_ms_all=ts, append_ms=append_ms,
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
        peak_memory_bytes=peak, **profile_calls(one_step))


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
        for flavour in argv[1:] or ["default"]:
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
