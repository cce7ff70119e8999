"""Batched scoring of recorded drives: the ``Loader`` feeds the port's
``model_forward`` in a closed loop (the next batch is taken once the
previous batch's logits are on the host).

Set-up: weights from the seed in the reference's format, loaded through
``models/convert.load_reference_state``; sequences from the frozen
generator (the configuration's rates and sizes), cut by the port's
``MemoryDataset``, shuffled by the seed, batched by its ``Loader`` in the
mix's mode (``prefetch`` 0: in the caller's thread, so that ``collate``
lies on the path of every batch; decode processes would put their slots
in ``/dev/shm``); one forward at each bucket the items reach, then a few
batches through the loop.  Window: batches until ``seconds`` have passed;
every box scored (``bbox`` + ``bbox0``, the reference's count) over the
window's seconds.  Then, with ``--trace 1``, a fixed count of batches
under the profiler.  Then ``correct``: a sample of the window's batches
drawn from the seed, with the batch of most events in it, collated again
by the reference from the same sequences and scored by the f32
reference; compared is the mean absolute gap of the valid slots' logits
from the reference's (the widest gap is printed with it: near-ties in the
max poolings make it swing from seed to seed, see ``PERF.md``)."""
from __future__ import annotations

import contextlib
import sys
import time

import numpy as np

from ..frozen.counts import PEAK_BF16, forward_roofline
from ..harness import core, trace as tr
from ..harness.program import drive, program_config, set_precision
from ..harness.traffic import sequences
from ..reference import data as rdata, model as rmodel
from ..reference.geometry import Geometry
from ..reference.weights import make_state, split


def build(cell, seed: int, dev):
    """Set-up shared by the loop and its calibration: ``(geo, cfg, sd,
    model, bc, mc, gsc, seqs, ds, sizes)``."""
    from eventad_tpu_torch.data.dataset import MemoryDataset
    from eventad_tpu_torch.models import dagr
    from eventad_tpu_torch.models.convert import load_reference_state
    geo = Geometry.of(cell.config["fields"])
    cfg = program_config(cell)
    sd = make_state(geo, seed, dev)
    model, bc, mc = dagr.init_model(cfg, None, dev)
    load_reference_state(model, *split(sd))
    seqs, sizes = sequences(geo, cell.config["traffic"], cell.mix, seed,
                            cell.mix["sequences"])
    return (geo, cfg, sd, model, bc, mc, dagr.graph_static_config(cfg),
            seqs, MemoryDataset(cfg, seqs), sizes)


def reference_diffs(sd, seqs, geo, records, pick, q=rmodel.f32,
                    compare_to=None):
    """Per picked window batch, the absolute differences of the valid
    slots' logits from the reference's (computed with ``q``): against the
    program's logits or, with ``compare_to`` (the f32 reference's logits
    per batch), between the two references.  Returns ``(differences, one
    flat tensor a batch; reference logits)``."""
    import torch
    dev = next(iter(sd.values())).device
    byname = {s["name"]: s for s in seqs}
    diffs, refs = [], []
    for j, i in enumerate(pick):
        names, frames, logits = records[i][:3]
        items = [rdata.cut(byname[n], f - 1, geo)
                 for n, f in zip(names, frames)]
        lg, valid = rmodel.score(sd, rmodel.to_device(
            rdata.collate(items, geo), dev), geo, q)
        got = (compare_to[j] if compare_to is not None
               else logits.to(dev))
        d = (got - lg).abs()[valid]
        diffs.append(torch.where(torch.isfinite(d), d, torch.inf).flatten())
        refs.append(lg)
    return diffs, refs


def gap_stats(diffs) -> dict:
    """The candidates a run could compare: the widest, mean and RMS
    absolute logit gap over every valid slot of the sample."""
    import torch
    d = torch.cat(diffs)
    return {"max": float(d.max()), "mean": float(d.mean()),
            "rms": float(torch.sqrt((d * d).mean()))}


def sample(records, n: int, seed: int):
    """``n`` window batches drawn from the seed, with the batch of most
    events among them."""
    rng = np.random.default_rng([seed, 1])
    longest = max(range(len(records)), key=lambda i: records[i][3])
    rest = [i for i in range(len(records)) if i != longest]
    k = min(n - 1, len(rest))
    return [longest] + sorted(rng.choice(rest, k, replace=False).tolist())


class Session:
    """One seed's scoring loop: set-up, warm-up, the timed window and the
    traced segment over one model, dataset and ``Loader``."""

    def __init__(self, cell, seed: int, dev):
        import torch
        from eventad_tpu_torch.data.batching import Loader, collate
        from eventad_tpu_torch.models import dagr
        set_precision(cell)
        self.cell, self.seed, self.dev = cell, seed, dev
        self.on_card = dev.type == "cuda"
        (self.geo, self.cfg, self.sd, self.model, self.bc, self.mc,
         self.gsc, self.seqs, ds, sizes) = build(cell, seed, dev)
        self._dagr, self._torch = dagr, torch
        cfg = self.cfg
        # every bucket the items reach, each with its largest item
        for b in sorted({rdata.pick_bucket(int(n), cfg.event_buckets)
                         for n in sizes}):
            fit = [i for i in range(len(sizes)) if sizes[i] <= b]
            top = max(fit, key=lambda i: sizes[i])
            idx = [top] + [i for i in fit if i != top][:cfg.batch_size - 1]
            for _ in range(2):
                self.score(collate([ds[i] for i in idx], cfg)[0])
        self.loader = Loader(ds, cfg, shuffle=True, seed=seed % 2 ** 31,
                             prefetch=cell.mix["prefetch"], num_workers=0)

        def batches():
            while True:
                yield from self.loader
        self.feed = batches()
        for _ in range(cell.mix["warmup_batches"]):
            self.score(next(self.feed)[0])
        if self.on_card:
            torch.cuda.synchronize()

    def score(self, batch, spans: bool = False):
        """The timed call: a batch to the card, ``model_forward``, the
        logits back on the host."""
        sp = tr.span if spans else (lambda _n: contextlib.nullcontext())
        with sp("copy_in"):
            gpu = batch.to(self.dev)
        with sp("forward"), self._torch.no_grad():
            logits = self._dagr.model_forward(self.model, gpu, self.bc,
                                              self.mc, self.gsc).logits
        with sp("copy_out"):
            return logits.cpu()

    def window(self, seconds: float) -> dict:
        """Batches until ``seconds`` have passed: ``records`` (per batch
        its sequences, frame ids, logits, valid events, boxes), the rate,
        the mean wait for the ``Loader`` and the model FLOPs' share of the
        peak."""
        records, waits, times, boxes, flops = [], [], [], 0, 0.0
        t0, c0 = time.perf_counter(), time.thread_time()
        deadline = t0 + seconds
        while True:
            tw = time.perf_counter()
            batch, meta = next(self.feed)
            waits.append(time.perf_counter() - tw)
            logits = self.score(batch)
            times.append(time.perf_counter() - tw)
            n_box = int(batch.bbox_mask.sum()) + int(batch.bbox0_mask.sum())
            records.append((meta.sequences, meta.frame_ids, logits,
                            int(batch.valid.sum()), n_box))
            boxes += n_box
            flops += forward_roofline(self.geo, int(batch.pos.shape[1]),
                                      self.cfg.compute_dtype)["flops"]
            if time.perf_counter() >= deadline:
                break
        window_s = time.perf_counter() - t0
        cpu = (time.thread_time() - c0) / window_s
        core.spread_line("batch", times, cpu)
        return {"records": records, "bboxes_per_s": boxes / window_s,
                "loader_wait_ms": 1e3 * float(np.mean(waits)),
                "mfu_pct": 100.0 * flops / window_s / PEAK_BF16}

    def traced(self, n: int) -> dict:
        """``n`` batches under the profiler, reduced."""
        with tr.KernelCalls() as calls, tr.traced() as prof:
            for _ in range(n):
                with tr.span("loader_wait"):
                    batch, _ = next(self.feed)
                self.score(batch, spans=True)
        return tr.reduce(prof, n, calls.bounds())

    def close(self) -> None:
        """Frees the program's state (the reference runs after it)."""
        del self.model, self.loader, self.feed
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
    reference and the control's (the reference in float8 e4m3, one scale
    a tensor, where the configuration states bf16), over the same
    sample."""
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
