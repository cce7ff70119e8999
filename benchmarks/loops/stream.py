"""A live stream: one camera's events in chunks through the port's
incremental step (``streaming/incremental``: ``append`` then
``read_scores``), closed loop: a chunk is handed over once the previous
chunk's scores are on the host.

Set-up: weights from the seed (reference format, ``load_reference_state``);
one long sequence from the frozen generator (the configuration's rates,
the mix's objects); the frame's CNN maps (``update_image``), the ring
filled with the first events and refreshed; ``warmup_chunks`` steps.  Each
chunk is ``chunk`` consecutive events with the boxes of the frame that
ends its time window.  Window: chunks until ``seconds`` have passed; each
chunk's time from its hand-over (the copy to the card) to its scores on
the host; ``chunk_ms_p95`` over all of them.  Then ``correct``: a sample
of the window's steps drawn from the seed, with the last in it.  For each,
the reference appends the ``replay`` chunks before it and the step's own
to an empty ring (which then equals the program's ring, see
``reference/stream``) and reads the scores with one head step from the
program's track state before the step (the state's history is the
program's; each sampled step's transition is checked, its new state
against the reference's).  Compared: the widest logit gap of a valid slot
and the widest gap of the new track state."""
from __future__ import annotations

import contextlib
import time

import numpy as np

from ..frozen.counts import PEAK_BF16, backbone_flops
from ..frozen.traffic import make_sequence
from ..harness import core, trace as tr
from ..harness.program import drive, program_config, set_precision
from ..reference import data as rdata, model as rmodel, stream as rstream


class Session:
    """One seed's stream: set-up, warm-up, window, traced segment."""

    def __init__(self, cell, seed: int, dev):
        import dataclasses

        import torch
        from eventad_tpu_torch.models import dagr
        from eventad_tpu_torch.models.convert import load_reference_state
        from eventad_tpu_torch.streaming import incremental as inc
        from ..reference.geometry import Geometry
        from ..reference.weights import make_state, split
        set_precision(cell)
        mix = cell.mix
        self.cell, self.seed, self.dev = cell, seed, dev
        self.on_card = dev.type == "cuda"
        self._torch = torch
        geo = dataclasses.replace(Geometry.of(cell.config["fields"]),
                                  batch_size=1)
        self.geo = geo
        cfg = program_config(cell).replace(batch_size=1)
        self.sd = make_state(geo, seed, dev)
        self.model, bc, mc = dagr.init_model(cfg, None, dev)
        load_reference_state(self.model, *split(self.sd))
        gsc = dagr.graph_static_config(cfg)
        rng = np.random.default_rng(seed)
        tr_cfg = cell.config["traffic"]
        seq = make_sequence(
            "stream", geo.model_width, geo.model_height, geo.scale,
            n_frames=mix["frames"], n_objects=mix["objects"],
            anomalous=True, toa_frame=mix["toa_frame"],
            seed=int(rng.integers(2 ** 31)),
            events_per_window=tr_cfg["events_per_window"], frame_scale=1,
            frame_us=tr_cfg["frame_us"])
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
        ts = seq["timestamps"]
        self.frames = []
        for f in range(len(ts)):
            b, p, _ = rdata._slot_boxes(
                rdata.frame_boxes(seq["tracks"], int(ts[f]), geo),
                geo.max_boxes)
            self.frames.append((torch.from_numpy(b).to(dev),
                                torch.from_numpy(p).to(dev)))
        last_t = self.pos[k - 1::k, 2].numpy()
        self.frame_of = np.minimum(np.searchsorted(ts, last_t, "right"),
                                   len(ts) - 1)
        image = torch.from_numpy(seq["images"][0].astype(np.float32)
                                 / 255.0).to(dev)
        self.image = image
        self.refresh, self.step = inc.make_incremental_step(
            self.model, bc, mc, gsc, n_chunk=k, n_buf=n_buf)
        st = inc.init_incremental_state(n_buf, bc, mc, cfg.max_neighbors,
                                        device=dev)
        st = inc.update_image(self.model, st, image)
        st = inc.insert_raw(st, self.pos[:n_buf].to(dev),
                            self.pol[:n_buf].to(dev), n_buf)
        self.state = self.refresh(st)
        self.next_chunk = n_buf // k
        self.flops = backbone_flops(geo, n_buf, streaming_changed=k)
        for _ in range(mix["warmup_chunks"]):
            self.chunk()
        if self.on_card:
            torch.cuda.synchronize()

    def chunk(self, spans: bool = False):
        """Hands the next chunk over and returns ``(chunk index, logits on
        the host, the track state before the step)``."""
        c = self.next_chunk
        if (c + 1) * self.k > len(self.pos):
            raise RuntimeError("the stream ran out of events: raise the "
                               "mix's frames")
        self.next_chunk += 1
        sp = tr.span if spans else (lambda _n: contextlib.nullcontext())
        boxes, present = self.frames[self.frame_of[c]]
        before = (self.state.h_event, self.state.h_coord, self.state.seen)
        with sp("copy_in"):
            p = self.pos[c * self.k:(c + 1) * self.k].to(self.dev)
            q = self.pol[c * self.k:(c + 1) * self.k].to(self.dev)
        with sp("step"):
            self.state, logits = self.step(self.state, p, q, self.k, boxes,
                                           present)
        with sp("copy_out"):
            return c, logits.cpu(), before

    def window(self, seconds: float) -> dict:
        records, lat = [], []
        t0, c0 = time.perf_counter(), time.thread_time()
        deadline = t0 + seconds
        while True:
            th = time.perf_counter()
            c, logits, before = self.chunk()
            lat.append(time.perf_counter() - th)
            after = (self.state.h_event, self.state.h_coord)
            records.append((c, logits, before, after))
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
        del self.model, self.step, self.refresh, self.state
        if self.on_card:
            self._torch.cuda.empty_cache()


def sample(records, n: int, seed: int):
    rng = np.random.default_rng([seed, 2])
    rest = list(range(len(records) - 1))
    k = min(n - 1, len(rest))
    return sorted(rng.choice(rest, k, replace=False).tolist()) + \
        [len(records) - 1]


def reference_gaps(s: Session, records, pick, replay: int,
                   q=rmodel.f32, compare_to=None):
    """Per picked step: the reference's ring after the ``replay`` chunks
    before it and its own, its read from the program's state before the
    step; the widest logit gap (valid slots) and state gap from the
    program's (or, with ``compare_to``, from another reference's
    ``(logits, state)`` per step).  Returns ``(logit gaps, state gaps,
    reference outputs)``."""
    import torch
    dev = next(iter(s.sd.values())).device
    feats = rmodel.cnn_features(s.sd, s.image[None], s.geo, q)
    lgaps, sgaps, outs = [], [], []
    for j, i in enumerate(pick):
        c, logits, before, after = records[i]
        ring = rstream.empty_ring(s.n_buf, s.geo, dev)
        for cc in range(c - replay, c + 1):
            ring = rstream.append(
                s.sd, s.geo, feats, ring,
                s.pos[cc * s.k:(cc + 1) * s.k].to(dev),
                s.pol[cc * s.k:(cc + 1) * s.k].to(dev), q)
        boxes, present = s.frames[s.frame_of[c]]
        lg, state, valid = rstream.read(s.sd, s.geo, feats, ring, boxes,
                                        present, before, q)
        got_lg, got_state = ((logits.to(dev), after) if compare_to is None
                             else compare_to[j])
        lgap = torch.where(valid[:, None], (got_lg - lg).abs(), 0.0).max()
        sgap = max(float((a - b).abs().max())
                   for a, b in zip(got_state, state[:2]))
        lgaps.append(float(lgap) if torch.isfinite(lgap) else float("inf"))
        sgaps.append(sgap if np.isfinite(sgap) else float("inf"))
        outs.append((lg, state[:2]))
    return lgaps, sgaps, outs


def _judge(s: Session, records):
    import torch
    rmodel.strict_f32()
    pick = sample(records, s.cell.mix["sample_chunks"], s.seed)
    lgaps, sgaps, _ = reference_gaps(s, records, pick, s.cell.mix["replay"])
    failed = sum(1 for r in records if not torch.isfinite(r[1]).all())
    return failed, {"logit_gap": max(lgaps), "state_gap": max(sgaps)}


def run(cell, seed: int, seconds: float, trace: bool, dev,
        t_start: float) -> None:
    drive(cell, Session(cell, seed, dev), seconds, trace, t_start, _judge)


def calibrate(cell, seed: int, seconds: float, dev) -> dict:
    """One seed's readings: the program's gaps from the f32 reference and
    the control's (the reference in float8 e4m3)."""
    s = Session(cell, seed, dev)
    records = s.window(seconds)["records"]
    s.close()
    rmodel.strict_f32()
    pick = sample(records, cell.mix["sample_chunks"], seed)
    lp, sp_, refs = reference_gaps(s, records, pick, cell.mix["replay"])
    lc, sc, _ = reference_gaps(s, records, pick, cell.mix["replay"],
                               q=rmodel.fp8, compare_to=refs)
    return {"program": [max(lp), max(sp_)], "control": [max(lc), max(sc)],
            "units": len(records)}
