"""Batched scoring of recorded drives whose event tables are decoded and
resident on the card: the ``score`` loop's batches, collated once at
set-up and staged on the card, cycled through the port's ``model_forward``
in a closed loop (the next batch is taken once the previous batch's
logits are on the host).  Isolates the forward's host dispatch from the
``Loader``, whose ``collate`` gaps hide it in ``rol.score``.

Set-up: ``score.build`` (weights from the seed, the frozen generator's
sequences, the port's ``MemoryDataset``); one epoch of its ``Loader``
(shuffled by the seed, in the caller's thread), every batch moved to the
card with ``EventBatch.to``; each staged batch scored once (every shape
the window uses), then ``warmup_batches`` through the loop.  Window: the
staged batches in an order drawn from the seed, cycled, until ``seconds``
have passed; every box scored (``bbox`` + ``bbox0``) over the window's
seconds.  ``correct``: as ``score``'s, on a sample of the window's
batches, each collated again by the reference from its sequences."""
from __future__ import annotations

import contextlib
import sys
import time

import numpy as np

from ..frozen.counts import PEAK_BF16, forward_roofline
from ..harness import core, trace as tr
from ..harness.program import drive, set_precision
from ..reference import model as rmodel
from .score import build, gap_stats, reference_diffs, sample


class Session:
    """One seed's staged scoring loop: set-up, warm-up, the timed window
    and the traced segment."""

    def __init__(self, cell, seed: int, dev):
        import torch
        from eventad_tpu_torch.data.batching import Loader
        from eventad_tpu_torch.models import dagr
        set_precision(cell)
        self.cell, self.seed, self.dev = cell, seed, dev
        self.on_card = dev.type == "cuda"
        (self.geo, self.cfg, self.sd, self.model, self.bc, self.mc,
         self.gsc, self.seqs, ds, _) = build(cell, seed, dev)
        self._dagr, self._torch = dagr, torch
        loader = Loader(ds, self.cfg, shuffle=True, seed=seed % 2 ** 31,
                        prefetch=cell.mix["prefetch"], num_workers=0)
        # per staged batch: (the batch on the card, its sequences, frame
        # ids, valid events, boxes, FLOPs)
        self.staged = []
        for batch, meta in loader:
            n_box = int(batch.bbox_mask.sum()) + int(batch.bbox0_mask.sum())
            self.staged.append((
                batch.to(dev), meta.sequences, meta.frame_ids,
                int(batch.valid.sum()), n_box,
                forward_roofline(self.geo, int(batch.pos.shape[1]),
                                 self.cfg.compute_dtype)["flops"]))
        rng = np.random.default_rng([seed, 3])
        self.order = rng.permutation(len(self.staged)).tolist()
        self.next = 0
        for st in self.staged:
            self.score(st[0])
        for _ in range(cell.mix["warmup_batches"]):
            self.score(self.take()[0])
        if self.on_card:
            torch.cuda.synchronize()

    def take(self):
        """The next staged batch of the seed's cycle."""
        st = self.staged[self.order[self.next % len(self.order)]]
        self.next += 1
        return st

    def score(self, gpu, spans: bool = False):
        """The timed call: ``model_forward`` on a staged batch, the logits
        back on the host."""
        sp = tr.span if spans else (lambda _n: contextlib.nullcontext())
        with sp("forward"), self._torch.no_grad():
            logits = self._dagr.model_forward(self.model, gpu, self.bc,
                                              self.mc, self.gsc).logits
        with sp("copy_out"):
            return logits.cpu()

    def window(self, seconds: float) -> dict:
        """Batches until ``seconds`` have passed: ``records`` (per batch
        its sequences, frame ids, logits, valid events, boxes), the rate
        and the model FLOPs' share of the peak."""
        records, times, boxes, flops = [], [], 0, 0.0
        t0, c0 = time.perf_counter(), time.thread_time()
        deadline = t0 + seconds
        while True:
            tw = time.perf_counter()
            gpu, names, frames, n_valid, n_box, fl = self.take()
            logits = self.score(gpu)
            times.append(time.perf_counter() - tw)
            records.append((names, frames, logits, n_valid, n_box))
            boxes += n_box
            flops += fl
            if time.perf_counter() >= deadline:
                break
        window_s = time.perf_counter() - t0
        cpu = (time.thread_time() - c0) / window_s
        core.spread_line("batch", times, cpu)
        return {"records": records, "bboxes_per_s": boxes / window_s,
                "mfu_pct": 100.0 * flops / window_s / PEAK_BF16}

    def traced(self, n: int) -> dict:
        """``n`` batches under the profiler, reduced."""
        with tr.KernelCalls() as calls, tr.traced() as prof:
            for _ in range(n):
                self.score(self.take()[0], spans=True)
        return tr.reduce(prof, n, calls.bounds())

    def close(self) -> None:
        """Frees the program's state (the reference runs after it)."""
        del self.model, self.staged
        if self.on_card:
            self._torch.cuda.empty_cache()


def _judge(s: Session, records):
    import torch
    rmodel.strict_f32()
    pick = sample(records, s.cell.mix["sample_batches"], s.seed)
    diffs, _ = reference_diffs(s.sd, s.seqs, s.geo, records, pick)
    failed = sum(1 for r in records if not torch.isfinite(r[2]).all())
    stats = gap_stats(diffs)
    print(f"widest logit gap {stats['max']!r}", file=sys.stderr)
    return failed, {"logit_gap_mean": stats["mean"]}


def run(cell, seed: int, seconds: float, trace: bool, dev,
        t_start: float) -> None:
    drive(cell, Session(cell, seed, dev), seconds, trace, t_start, _judge)


def calibrate(cell, seed: int, seconds: float, dev) -> dict:
    """One seed's readings: the program's logit gaps from the f32
    reference and the control's (the reference in float8 e4m3), over the
    same sample."""
    s = Session(cell, seed, dev)
    records = s.window(seconds)["records"]
    s.close()
    rmodel.strict_f32()
    pick = sample(records, cell.mix["sample_batches"], seed)
    prog, refs = reference_diffs(s.sd, s.seqs, s.geo, records, pick)
    ctrl, _ = reference_diffs(s.sd, s.seqs, s.geo, records, pick,
                              q=rmodel.fp8, compare_to=refs)
    return {"program": gap_stats(prog), "control": gap_stats(ctrl),
            "units": len(records)}
