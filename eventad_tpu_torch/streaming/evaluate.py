"""Streaming evaluation: the stream-against-batch consistency check, the
latency benches and the dense-against-incremental FLOP count (counterpart of
``eventad_tpu/streaming/evaluate.py``; reference ``evaluate_flops``,
src/dagr/asynchronous/evaluate_flops.py:82-261).

Times are host-clock milliseconds of one call ending in a synchronise of the
card (on the CPU, of the call alone), the host's share of the call inside;
on the card :func:`device_times_incremental` gives per-dispatch and
device-true times (``utils/devtime``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..config import Config
from ..data.batching import EventBatch
from ..models.backbone import make_backbone_config
from ..models.dagr import EventADModel, graph_static_config, model_forward
from ..models.detector import init_detector
from ..models.eventad import EventADConfig
from ..native import queue_ranks
from ..utils.devtime import dispatch_floor_ms, trace_device_ms
from ..utils.flops import backbone_flops
from . import incremental as inc
from .detect import make_incremental_detector, update_image_detector
from .runner import make_stream_step, update_image
from .state import init_streaming_state


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _timed_ms(fn, dev) -> tuple:
    """``(result, ms)`` of one call of ``fn`` ended by a synchronise."""
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    return out, (time.perf_counter() - t0) * 1e3


def _p50(ts) -> float:
    return float(np.sort(ts)[len(ts) // 2])


def _p99(ts) -> float:
    ts = np.sort(ts)
    return float(ts[max(int(len(ts) * 0.99) - 1, 0)])


# device_times_incremental: steps traced after warm-up steps, and calls a
# pipelined run enqueues
TRACE_WARM, TRACE_ITERS = 3, 8
PIPELINED_CALLS = 30


def _head_config(cfg: Config) -> EventADConfig:
    return EventADConfig(x_dim=cfg.x_dim, h_dim=cfg.h_dim,
                         max_boxes=cfg.max_boxes)


def consistency_check(model: EventADModel, cfg: Config,
                      events_pos: np.ndarray, events_pol: np.ndarray,
                      boxes: np.ndarray, box_present: np.ndarray, *,
                      n_chunks: int = 4):
    """One window of events through the batch path (``model_forward`` at
    batch 1) and through the dense streaming step in ``n_chunks`` pieces,
    on the model's device; compares the final logits of the valid slots.
    Equal when the stream buffer covers the window: the neighbour search
    sees the same candidates and the head runs one recurrent step either
    way.  Returns ``(max_abs_diff, batch_logits, stream_logits)``, the
    logits on the CPU."""
    dev = _device(model)
    cfg1 = cfg.replace(batch_size=1)
    bc = make_backbone_config(cfg1)
    mc = _head_config(cfg)
    gsc = graph_static_config(cfg1)
    n = len(events_pol)
    s1 = cfg.max_boxes + 1

    # ---- batch path: one forward over the whole window ----
    t_now = int(events_pos[:, 2].max())
    pos_rel = events_pos.astype(np.int32).copy()
    pos_rel[:, 2] = events_pos[:, 2] - t_now + cfg.time_window_us
    ranks = queue_ranks(pos_rel[:, 0], pos_rel[:, 1], cfg.model_width,
                        cfg.model_height)

    def both_frames(a):
        return torch.from_numpy(np.broadcast_to(
            a[None, None], (1, 2) + a.shape).copy())
    image = torch.zeros((1, cfg.model_height, cfg.model_width, 3))
    batch = EventBatch(
        pos=torch.from_numpy(pos_rel[None]),
        polarity=torch.from_numpy(events_pol.astype(np.float32)[None]),
        valid=torch.ones((1, n), dtype=torch.bool),
        rank=torch.from_numpy(ranks[None]), image=image,
        boxes=both_frames(boxes.astype(np.float32)),
        box_present=both_frames(box_present.astype(bool)),
        box_labels=torch.zeros((1, s1), dtype=torch.int32),
        bbox_mask=torch.ones((1, 1), dtype=torch.bool),
        bbox0_mask=torch.ones((1, 1), dtype=torch.bool),
        bbox=torch.zeros((1, 1, 6))).to(dev)
    out = model_forward(model, batch, bc, mc, gsc)
    batch_logits = out.logits[0]

    # ---- streaming path: the same events in chunks, logits at the end ----
    chunk = -(-n // n_chunks)
    sstate = init_streaming_state(n, cfg.max_boxes, cfg.h_dim, device=dev)
    if bc.use_image:
        sstate = update_image(model, sstate, batch.image[0])
    step = make_stream_step(model, bc, mc, gsc, n_chunk=chunk)
    no_boxes = torch.zeros((s1, 4), device=dev)
    no_present = torch.zeros((s1,), dtype=torch.bool, device=dev)
    logits = None
    for ci in range(n_chunks):
        lo, hi = ci * chunk, min((ci + 1) * chunk, n)
        buf_pos = np.zeros((chunk, 3), np.int32)
        buf_pol = np.zeros((chunk,), np.float32)
        buf_pos[:hi - lo] = events_pos[lo:hi]
        buf_pol[:hi - lo] = events_pol[lo:hi]
        last = ci == n_chunks - 1
        # intermediate chunks carry no boxes (scores only at frame time)
        sstate, logits = step(
            sstate, torch.from_numpy(buf_pos).to(dev),
            torch.from_numpy(buf_pol).to(dev), hi - lo,
            batch.boxes[0, 1] if last else no_boxes,
            batch.box_present[0, 1] if last else no_present)
    valid = out.valid[0][:, None]
    diff = (torch.where(valid, batch_logits, 0.0)
            - torch.where(valid, logits, 0.0)).abs().max()
    return float(diff), batch_logits.cpu(), logits.cpu()


class SyntheticStream:
    """Synthetic chunks as the benches feed them, on ``dev``: uniform
    pixels, sorted times from 10^6 us, each chunk 2 ms after the last, and
    a uniform frame, from ``seed``."""

    def __init__(self, cfg: Config, n_chunk: int, seed: int, dev):
        self.rng = np.random.RandomState(seed)
        self.cfg, self.n_chunk, self.dev = cfg, n_chunk, dev
        self.t_base = 1_000_000

    def chunk(self) -> torch.Tensor:
        ev = np.zeros((self.n_chunk, 3), np.int32)
        ev[:, 0] = self.rng.randint(0, self.cfg.model_width, self.n_chunk)
        ev[:, 1] = self.rng.randint(0, self.cfg.model_height, self.n_chunk)
        ev[:, 2] = self.t_base + np.sort(self.rng.randint(0, 2000,
                                                          self.n_chunk))
        self.t_base += 2000
        return torch.from_numpy(ev).to(self.dev)

    def image(self) -> torch.Tensor:
        return torch.from_numpy(self.rng.rand(
            self.cfg.model_height, self.cfg.model_width, 3)
            .astype(np.float32)).to(self.dev)


def bench_boxes(cfg: Config, boxes_per_frame: int, dev):
    """``(boxes [S+1, 4], present [S+1])``: ``boxes_per_frame`` 20x20-pixel
    boxes in slots 1, 2, ..."""
    s1 = cfg.max_boxes + 1
    boxes = np.zeros((s1, 4), np.float32)
    present = np.zeros((s1,), bool)
    for k in range(boxes_per_frame):
        boxes[k + 1] = (10 + 20 * k, 10, 30, 30)
        present[k + 1] = True
    return (torch.from_numpy(boxes).to(dev),
            torch.from_numpy(present).to(dev))


def latency_bench(model: EventADModel, cfg: Config, *, n_buf: int = 16384,
                  n_chunk: int = 512, iters: int = 50,
                  boxes_per_frame: int = 4, seed: int = 0) -> dict:
    """p50/p99 per-chunk latency of the dense streaming step (a whole
    backbone pass over the buffer per chunk), 5 warm-up steps first."""
    dev = _device(model)
    cfg1 = cfg.replace(batch_size=1)
    bc = make_backbone_config(cfg1)
    ev = SyntheticStream(cfg, n_chunk, seed, dev)
    sstate = init_streaming_state(n_buf, cfg.max_boxes, cfg.h_dim,
                                  device=dev)
    if bc.use_image:
        sstate = update_image(model, sstate, ev.image())
    step = make_stream_step(model, bc, _head_config(cfg),
                            graph_static_config(cfg1), n_chunk=n_chunk)
    boxes, present = bench_boxes(cfg, boxes_per_frame, dev)
    ones = torch.ones((n_chunk,), device=dev)
    times = []
    for i in range(iters + 5):
        ck = ev.chunk()
        (sstate, _), ms = _timed_ms(
            lambda: step(sstate, ck, ones, n_chunk, boxes, present), dev)
        if i >= 5:
            times.append(ms)
    return {"p50_ms": _p50(times), "p99_ms": _p99(times),
            "mean_ms": float(np.mean(times)), "events_per_chunk": n_chunk}


def _filled_stream(model: EventADModel, cfg: Config, n_buf: int,
                   n_chunk: int, boxes_per_frame: int, seed: int) -> tuple:
    """An incremental stream of ``SyntheticStream(seed)`` chunks, the ring
    filled raw with ``n_buf`` events (and the image), then refreshed:
    ``(stream, state, refresh, step, boxes, present, ones)``."""
    dev = _device(model)
    cfg1 = cfg.replace(batch_size=1)
    bc = make_backbone_config(cfg1)
    mc = _head_config(cfg)
    ev = SyntheticStream(cfg, n_chunk, seed, dev)
    st = inc.init_incremental_state(n_buf, bc, mc,
                                    max_neighbors=cfg.max_neighbors,
                                    device=dev)
    if bc.use_image:
        st = inc.update_image(model, st, ev.image())
    refresh, step = inc.make_incremental_step(model, bc, mc,
                                              graph_static_config(cfg1),
                                              n_chunk=n_chunk, n_buf=n_buf)
    boxes, present = bench_boxes(cfg, boxes_per_frame, dev)
    ones = torch.ones((n_chunk,), device=dev)
    for _ in range(n_buf // n_chunk):
        st = inc.insert_raw(st, ev.chunk(), ones, n_chunk)
    return ev, refresh(st), refresh, step, boxes, present, ones


def latency_bench_incremental(model: EventADModel, cfg: Config, *,
                              n_buf: int = 16384, n_chunk: int = 512,
                              iters: int = 50, boxes_per_frame: int = 4,
                              seed: int = 0) -> dict:
    """Latencies of the incremental streaming step: the ring filled with
    ``n_buf`` events and refreshed, then per chunk a ``step`` (append +
    read) and an ``append``, ``iters`` of each after 5 warm-up rounds; one
    ``read_scores`` per call on the final state; ``append_many`` and
    ``step.many`` over ``iters`` chunks (times per chunk, the chunks' times
    moved past the stream's clock, on the card before the clock starts)."""
    dev = _device(model)
    ev, st, refresh, step, boxes, present, ones = _filled_stream(
        model, cfg, n_buf, n_chunk, boxes_per_frame, seed)
    st, refresh_ms = _timed_ms(lambda: refresh(st), dev)

    times, atimes = [], []
    for i in range(iters + 5):
        ck = ev.chunk()
        (st, _), ms = _timed_ms(
            lambda: step(st, ck, ones, n_chunk, boxes, present), dev)
        ck = ev.chunk()
        st, ams = _timed_ms(lambda: step.append(st, ck, ones, n_chunk), dev)
        if i >= 5:
            times.append(ms)
            atimes.append(ams)
    rtimes = [_timed_ms(lambda: step.read_scores(st, boxes, present),
                        dev)[1] for _ in range(iters)]

    # M chunks a call: their times relative, moved past the state's clock
    m = iters
    rel = torch.stack([ev.chunk() for _ in range(m)])
    rel[..., 2] -= int(rel[0, 0, 2]) - 1
    pols = torch.ones((m, n_chunk), device=dev)
    counts = torch.full((m,), n_chunk, dtype=torch.int32, device=dev)
    bxs = boxes.expand(m, *boxes.shape)
    bps = present.expand(m, *present.shape)

    def fresh(s):
        pcs = rel.clone()
        pcs[..., 2] += s.t_now
        return pcs

    def per_chunk_ms(run, reps=3):
        """Median ms per chunk of ``run(state, chunks) -> state`` over
        ``reps`` calls after one to warm up."""
        s = run(st, fresh(st))
        ts = []
        for _ in range(reps):
            pcs = fresh(s)
            s, ms = _timed_ms(lambda: run(s, pcs), dev)
            ts.append(ms / m)
        return _p50(ts)

    append_scan_ms = per_chunk_ms(
        lambda s, pcs: step.append_many(s, pcs, pols, counts))
    step_scan_ms = per_chunk_ms(
        lambda s, pcs: step.many(s, pcs, pols, counts, bxs, bps)[0])
    return {
        "p50_ms": _p50(times), "p99_ms": _p99(times),
        "mean_ms": float(np.mean(times)), "append_p50_ms": _p50(atimes),
        "refresh_ms": refresh_ms, "device_read_ms": _p50(rtimes),
        "device_append_scan_ms": append_scan_ms,
        "device_step_scan_ms": step_scan_ms, "events_per_chunk": n_chunk}


def device_times_incremental(model: EventADModel, cfg: Config, *,
                             n_buf: int = 16384, n_chunk: int = 512,
                             boxes_per_frame: int = 4,
                             seed: int = 0) -> dict:
    """The card's figures of the incremental step (the root bench's keys),
    on a stream set up as :func:`latency_bench_incremental` sets it up:
    ``device_step_trace_ms``, the union of one step's device intervals in a
    trace of ``TRACE_ITERS`` steps after ``TRACE_WARM``; ``device_step_ms``
    and ``device_append_ms``, ``PIPELINED_CALLS`` calls on chunks staged on
    the card, then one synchronise, per call; ``dispatch_floor_ms``, a
    scalar add's.  The trace comes first; it must be the process's first
    (later traces lose device events, and then this raises).  Raises on the
    CPU."""
    ev, st, _, step, boxes, present, ones = _filled_stream(
        model, cfg, n_buf, n_chunk, boxes_per_frame, seed)
    dev = _device(model)
    cks = [ev.chunk() for _ in range(TRACE_WARM + TRACE_ITERS)]
    live = [st]

    def one_step():
        live[0] = step(live[0], cks.pop(0), ones, n_chunk, boxes,
                       present)[0]
    for _ in range(TRACE_WARM):
        one_step()
    out = {"device_step_trace_ms": trace_device_ms(one_step,
                                                   iters=TRACE_ITERS)}
    st = live[0]

    def pipelined_ms(call):
        """ms per call of ``call(state, chunk) -> state`` over
        ``PIPELINED_CALLS`` calls on staged chunks, one synchronise, after
        one call to warm up."""
        staged = [ev.chunk() for _ in range(PIPELINED_CALLS + 1)]
        s = call(st, staged[0])
        _sync(dev)
        t0 = time.perf_counter()
        for ck in staged[1:]:
            s = call(s, ck)
        _sync(dev)
        return (time.perf_counter() - t0) / PIPELINED_CALLS * 1e3
    out["device_step_ms"] = pipelined_ms(
        lambda s, ck: step(s, ck, ones, n_chunk, boxes, present)[0])
    out["device_append_ms"] = pipelined_ms(
        lambda s, ck: step.append(s, ck, ones, n_chunk))
    out["dispatch_floor_ms"] = dispatch_floor_ms()
    return out


def latency_bench_detect(cfg: Config, *, n_buf: int = 16384,
                         n_chunk: int = 512, iters: int = 20, seed: int = 0,
                         device=None) -> dict:
    """Milliseconds of one streaming detection read-out (``read_detections``:
    pooling, pooled levels, GNN head, fusion, decode, NMS from the cached
    level-0 state), median of ``iters`` calls, a detector from seed 0 on
    ``device`` (the CUDA card unless the caller names the CPU)."""
    cfg1 = cfg.replace(batch_size=1)
    detector, bc = init_detector(cfg1, torch.Generator().manual_seed(0),
                                 device)
    dev = _device(detector)
    ev = SyntheticStream(cfg, n_chunk, seed, dev)
    st = inc.init_incremental_state(n_buf, bc, EventADConfig(),
                                    max_neighbors=cfg.max_neighbors,
                                    device=dev)
    refresh, step = make_incremental_detector(
        detector, bc, graph_static_config(cfg1), n_chunk=n_chunk,
        n_buf=n_buf)
    read_det = step.read_detections
    if bc.use_image:
        st = update_image_detector(detector, st, ev.image(), bc)
    ones = torch.ones((n_chunk,), device=dev)
    for _ in range(n_buf // n_chunk):
        st = inc.insert_raw(st, ev.chunk(), ones, n_chunk)
    st = refresh(st)
    read_det(st)
    ts = [_timed_ms(lambda: read_det(st), dev)[1] for _ in range(iters)]
    return {"device_read_detections_ms": _p50(ts)}


def flops_report(cfg: Config, n_events: int, changed_events: int) -> dict:
    """Dense against incremental FLOPs of the backbone (the
    ``evaluate_flops`` analog)."""
    bc = make_backbone_config(cfg)
    dense = backbone_flops(bc, n_events)
    delta = backbone_flops(bc, n_events, streaming_changed=changed_events)
    return {
        "dense_mflops": dense.total() / 1e6,
        "delta_mflops": delta.total() / 1e6,
        "ratio": delta.total() / max(dense.total(), 1.0),
        "dense_by_layer": dense.by_layer(),
        "delta_by_layer": delta.by_layer(),
    }
