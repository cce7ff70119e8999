"""A live detection stream: one camera's events in chunks through the
port's streaming detector (``streaming/detect``: the step appends a chunk,
then reads the boxes), closed loop: a chunk is handed over once the
previous chunk's detections (boxes, scores, labels, mask) are on the host.

Set-up: the backbone's weights from the seed (reference format), the
head's and the output remaps' from the seed (``reference/detect_weights``,
the CNN head's batch norms fitted to the frame), loaded through
``models/convert.load_detector_state``; one long sequence from the frozen
generator (the configuration's rates, the mix's objects); the frame's CNN
work (``update_image_detector``), the ring filled with the first events
and refreshed; ``warmup_chunks`` steps.  Window: chunks until ``seconds``
have passed; each chunk's time from its hand-over (the copy to the card)
to its detections on the host; ``chunk_ms_p95`` over all of them.  Then
``correct``: a sample of the window's steps drawn from the seed, with the
last in it.  For each, the reference appends the ``replay`` chunks before
it and the step's own to an empty ring (which then equals the program's
ring, see ``reference/stream``) and reads the decoded outputs.  Compared:
``score_gap``, the widest gap of an anchor's objectness or class
probability; ``box_gap``, the widest gap of an anchor's decoded x, y, w or
h over the larger of its stride and the box's extent (see :func:`gaps`);
``nms_mismatch``, the kept slots (anchor and order) in
which the program's detections differ from the reference NMS run on the
program's own decoded outputs (a count held under 0.5, so none may
differ: on equal inputs NMS has no rounding to forgive)."""
from __future__ import annotations

import contextlib
import sys
import time

import numpy as np

from ..frozen.detect_counts import chunk_flops
from ..frozen.counts import PEAK_BF16
from ..frozen.traffic import make_sequence
from ..harness import core, trace as tr
from ..harness.program import drive, program_config, set_precision
from ..reference import detect as rdet, model as rmodel, stream as rstream
from .stream import sample


class Session:
    """One seed's detection stream: set-up, warm-up, window, traced
    segment."""

    def __init__(self, cell, seed: int, dev):
        import dataclasses

        import torch
        from eventad_tpu_torch.models.convert import load_detector_state
        from eventad_tpu_torch.models.dagr import graph_static_config
        from eventad_tpu_torch.models.detector import init_detector
        from eventad_tpu_torch.models.eventad import EventADConfig
        from eventad_tpu_torch.streaming import detect as sdet
        from eventad_tpu_torch.streaming import incremental as inc
        from ..reference.detect_weights import (detector_tree,
                                                fit_cnn_statistics,
                                                make_head)
        from ..reference.geometry import Geometry
        from ..reference.weights import make_state
        set_precision(cell)
        mix = cell.mix
        self.cell, self.seed, self.dev = cell, seed, dev
        self.on_card = dev.type == "cuda"
        self._torch = torch
        geo = dataclasses.replace(Geometry.of(cell.config["fields"]),
                                  batch_size=1)
        self.geo, self.head = geo, rdet.Head.of(cell.config)
        cfg = program_config(cell).replace(batch_size=1)
        rng = np.random.default_rng(seed)
        tr_cfg = cell.config["traffic"]
        seq = make_sequence(
            "stream", geo.model_width, geo.model_height, geo.scale,
            n_frames=mix["frames"], n_objects=mix["objects"],
            anomalous=True, toa_frame=mix["toa_frame"],
            seed=int(rng.integers(2 ** 31)),
            events_per_window=tr_cfg["events_per_window"], frame_scale=1,
            frame_us=tr_cfg["frame_us"])
        self.image = torch.from_numpy(seq["images"][0].astype(np.float32)
                                      / 255.0).to(dev)
        self.sd = make_state(geo, seed, dev)
        rmodel.strict_f32()
        self.hd = fit_cnn_statistics(
            self.sd, make_head(geo, self.head, seed, dev), self.image[None],
            geo)
        set_precision(cell)
        self.detector, bc = init_detector(cfg, None, dev)
        load_detector_state(self.detector,
                            *detector_tree(self.sd, self.hd, geo))
        made = sdet.make_incremental_detector(
            self.detector, bc, graph_static_config(cfg), n_chunk=mix["chunk"],
            n_buf=mix["ring"])
        if len(made) != 2:
            sys.exit("the program's streaming detector has no step")
        self.refresh, self.step = made
        ev = seq["events"]
        pos = np.stack([ev["x"], ev["y"], ev["t"]], 1).astype(np.int32)
        pol = (2.0 * ev["p"] - 1.0).astype(np.float32)
        k, n_buf = mix["chunk"], mix["ring"]
        n_chunks = (len(pos) - n_buf) // k
        self.k, self.n_buf = k, n_buf
        # chunk c holds events [c k, (c + 1) k); the ring starts full with
        # chunks 0 .. n_buf / k - 1
        self.pos = torch.from_numpy(pos[:n_buf + n_chunks * k].copy())
        self.pol = torch.from_numpy(pol[:n_buf + n_chunks * k].copy())
        st = inc.init_incremental_state(n_buf, bc, EventADConfig(),
                                        cfg.max_neighbors, device=dev)
        st = sdet.update_image_detector(self.detector, st, self.image, bc)
        st = inc.insert_raw(st, self.pos[:n_buf].to(dev),
                            self.pol[:n_buf].to(dev), n_buf)
        self.state = self.refresh(st)
        self.next_chunk = n_buf // k
        self.flops = chunk_flops(geo, n_buf, k, self.head)
        for _ in range(mix["warmup_chunks"]):
            self.chunk()
        if self.on_card:
            torch.cuda.synchronize()

    def chunk(self, spans: bool = False):
        """Hands the next chunk over and returns ``(chunk index, detections
        on the host, decoded outputs on the card)``."""
        c = self.next_chunk
        if (c + 1) * self.k > len(self.pos):
            raise RuntimeError("the stream ran out of events: raise the "
                               "mix's frames")
        self.next_chunk += 1
        sp = tr.span if spans else (lambda _n: contextlib.nullcontext())
        with sp("copy_in"):
            p = self.pos[c * self.k:(c + 1) * self.k].to(self.dev)
            q = self.pol[c * self.k:(c + 1) * self.k].to(self.dev)
        with sp("step"):
            self.state, (dets, decoded) = self.step(self.state, p, q,
                                                    self.k)
        with sp("copy_out"):
            return c, {n: v.cpu() for n, v in dets.items()}, decoded

    def window(self, seconds: float) -> dict:
        records, lat = [], []
        t0, c0 = time.perf_counter(), time.thread_time()
        deadline = t0 + seconds
        while True:
            th = time.perf_counter()
            records.append(self.chunk())
            lat.append(time.perf_counter() - th)
            if time.perf_counter() >= deadline:
                break
        window_s = time.perf_counter() - t0
        cpu = (time.thread_time() - c0) / window_s
        core.spread_line("chunk", lat, cpu)
        return {"records": records,
                "chunk_ms_p95": 1e3 * core.p95(lat),
                "chunk_ms_p50": 1e3 * float(np.median(lat)),
                "mfu_pct": 100.0 * self.flops * len(records) / window_s
                / PEAK_BF16}

    def traced(self, n: int) -> dict:
        with tr.KernelCalls() as calls, tr.traced() as prof:
            for _ in range(n):
                self.chunk(spans=True)
        return tr.reduce(prof, n, calls.bounds())

    def close(self) -> None:
        del self.detector, self.step, self.refresh, self.state
        if self.on_card:
            self._torch.cuda.empty_cache()


def reference_decoded(s: Session, records, pick, replay: int,
                      q=rmodel.f32):
    """Per picked step the reference's decoded outputs ``[1, A, 5 + C]``:
    its ring after the ``replay`` chunks before the step and the step's
    own, read by both heads."""
    dev = s.image.device
    feats = rmodel.cnn_features(s.sd, s.image[None], s.geo, q)
    cnn = rdet.cnn_head(s.sd, s.hd, s.image[None], s.geo, q)
    out = []
    for i in pick:
        c = records[i][0]
        ring = rstream.empty_ring(s.n_buf, s.geo, dev)
        for cc in range(c - replay, c + 1):
            ring = rstream.append(
                s.sd, s.geo, feats, ring,
                s.pos[cc * s.k:(cc + 1) * s.k].to(dev),
                s.pol[cc * s.k:(cc + 1) * s.k].to(dev), q)
        out.append(rdet.read(s.sd, s.hd, s.geo, feats, cnn, ring, q))
    return out


def gaps(s: Session, got, want):
    """``(score gap, box gap)`` between two lists of decoded outputs and
    the reference's (``want``): the widest gap of a probability, and of a
    box coordinate over the larger of its anchor's stride and the
    reference box's extent along that axis (w for x and w, h for y and
    h).  The box's extent enters because w and h are decoded through exp:
    over the stride alone, a box tens of strides wide would turn one
    rounding of its logit into tens of strides."""
    import torch
    grids, strides = rdet.head_geometry(s.geo)
    stride = torch.cat([torch.full((nx * ny,), float(st))
                        for (nx, ny), st in zip(grids, strides)])
    sg = bg = 0.0
    for a, b in zip(got, want):
        b = b.detach().cpu()[0]
        d = (a.detach().cpu()[0] - b).abs()
        d = torch.where(torch.isfinite(d), d, torch.inf)
        extent = b[:, [2, 3, 2, 3]].abs()
        scale = torch.maximum(stride[:, None], extent)
        sg = max(sg, float(d[:, 4:].max()))
        bg = max(bg, float((d[:, :4] / scale).max()))
    return sg, bg


def nms_mismatch(s: Session, records, pick) -> int:
    """Kept slots, over the picked steps, in which the program's
    detections differ from the reference NMS of its decoded outputs."""
    w, h = s.geo.model_width, s.geo.model_height
    return sum(rdet.mismatches(
        rdet.kept_of(records[i][1], records[i][2], s.head),
        rdet.nms(records[i][2], s.head, w, h)) for i in pick)


def _judge(s: Session, records):
    import torch
    rmodel.strict_f32()
    pick = sample(records, s.cell.mix["sample_chunks"], s.seed)
    refs = reference_decoded(s, records, pick, s.cell.mix["replay"])
    score_gap, box_gap = gaps(s, [records[i][2] for i in pick], refs)
    mism = nms_mismatch(s, records, pick)
    kept = [int(records[i][1]["mask"].sum()) for i in pick]
    print(f"kept detections in the sampled chunks {kept}", file=sys.stderr)
    failed = sum(1 for r in records if not torch.isfinite(r[2]).all())
    return failed, {"score_gap": score_gap, "box_gap": box_gap,
                    "nms_mismatch": float(mism)}


def run(cell, seed: int, seconds: float, trace: bool, dev,
        t_start: float) -> None:
    drive(cell, Session(cell, seed, dev), seconds, trace, t_start, _judge)


def calibrate(cell, seed: int, seconds: float, dev) -> dict:
    """One seed's readings: the program's gaps from the f32 reference and
    the control's (the reference in float8 e4m3), ``[score_gap,
    box_gap]``, and the program's NMS mismatches."""
    s = Session(cell, seed, dev)
    records = s.window(seconds)["records"]
    s.close()
    rmodel.strict_f32()
    pick = sample(records, cell.mix["sample_chunks"], seed)
    refs = reference_decoded(s, records, pick, cell.mix["replay"])
    ctrl = reference_decoded(s, records, pick, cell.mix["replay"],
                             q=rmodel.fp8)
    return {"program": list(gaps(s, [records[i][2] for i in pick], refs)),
            "control": list(gaps(s, ctrl, refs)),
            "nms_mismatch": nms_mismatch(s, records, pick),
            "units": len(records)}
