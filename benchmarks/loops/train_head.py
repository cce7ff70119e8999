"""Fine-tuning the anomaly head, the trained part of EventAD: the port's
``parallel/train_step`` step (the frozen f32 feature path with K1 and K6a,
the head in training mode with dropout from a seeded generator, backward
through the head, the global-norm clip, AdamW) over a fixed set of batches
staged on the card at set-up, cycled in a seeded order.

Set-up builds the one training object (model, optimizer, step, dropout
generator) and drives it through one cycle of the staged batches; its
first three steps, on three different batches, are the ones the reference
follows: their losses, the first gradient as the optimizer got it (its
first moment after one step over ``1 - beta1``) and the head's change over
the three steps are kept.  Window: steps until ``seconds`` have passed;
items trained over the window's seconds.  ``correct``: the reference
trains a copy of the same head on the same three batches, collated again
from the same sequences, with the same dropout masks (a generator of the
same seed on the same card), and the three numbers are compared (the
worst leaf's gap of norms over the larger of the leaf's and the median
leaf's reference norm; leaves whose reference gradient is under a
thousandth of the median leaf's are left out of the change)."""
from __future__ import annotations

import contextlib
import time

import numpy as np

from ..frozen.counts import PEAK_BF16, forward_roofline
from ..harness import core, trace as tr
from ..harness.program import drive, program_config, set_precision
from ..harness.traffic import sequences
from ..reference import data as rdata, model as rmodel, train as rtrain
from ..reference.geometry import Geometry
from ..reference.weights import make_state, split

# the program's head parameters (attribute paths under ``model.head``) and
# their reference-format keys
HEAD_KEYS = {
    "fusion.event_proj_w": "fusion_module.event_proj.weight",
    "fusion.event_proj_b": "fusion_module.event_proj.bias",
    "fusion.coord_proj_w": "fusion_module.coord_proj.weight",
    "fusion.coord_proj_b": "fusion_module.coord_proj.bias",
    "fusion.fuse1_w": "fusion_module.fusion.0.weight",
    "fusion.fuse1_b": "fusion_module.fusion.0.bias",
    "fusion.fuse2_w": "fusion_module.fusion.3.weight",
    "fusion.fuse2_b": "fusion_module.fusion.3.bias",
    "att_event_w": "soft_attention.weight",
    "att_coord_w": "soft_attention_cor.weight",
}
for _g, _p in (("gru_event", "gru_net_event.gru"),
               ("gru_coord", "gru_net_cor.gru")):
    for _i in range(2):
        for _a, _b in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                       ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
            HEAD_KEYS[f"{_g}.layers.{_i}.{_a}"] = f"{_p}.{_b}_l{_i}"
FOLLOWED = 3


def step_flops(geo: Geometry, n_events: int) -> float:
    """A head-training step's model FLOPs: the f32 forward's count and the
    head's backward, twice its forward."""
    fr = forward_roofline(geo, n_events, "float32")
    return fr["flops"] + 2.0 * fr["stages"]["box_head"][0]


class Session:
    """One seed's training object, staged batches, window and trace."""

    def __init__(self, cell, seed: int, dev):
        import torch
        from eventad_tpu_torch.data.batching import collate
        from eventad_tpu_torch.data.dataset import MemoryDataset
        from eventad_tpu_torch.models import dagr
        from eventad_tpu_torch.models.convert import load_reference_state
        from eventad_tpu_torch.parallel.train_step import (make_optimizer,
                                                           make_train_fns)
        set_precision(cell)
        mix = cell.mix
        self.cell, self.seed, self.dev = cell, seed, dev
        self.on_card = dev.type == "cuda"
        self._torch = torch
        self.geo = Geometry.of(cell.config["fields"])
        cfg = program_config(cell, "train")
        self.cfg = cfg
        self.sd = make_state(self.geo, seed, dev)
        self.model, bc, mc = dagr.init_model(cfg, None, dev)
        load_reference_state(self.model, *split(self.sd))
        self.seqs, _ = sequences(self.geo, cell.config["traffic"], mix, seed,
                                 mix["sequences"])
        ds = MemoryDataset(cfg, self.seqs)
        rng = np.random.default_rng([seed, 3])
        idx = rng.permutation(len(ds))[:mix["batches"] * cfg.batch_size]
        self.staged, self.metas = [], []
        for j in range(mix["batches"]):
            b, meta = collate([ds[int(i)] for i in idx[
                j * cfg.batch_size:(j + 1) * cfg.batch_size]], cfg)
            self.staged.append(b.to(dev))
            self.metas.append((meta.sequences, meta.frame_ids))
        self.order = rng.permutation(mix["batches"])
        self.opt = make_optimizer(self.model.head.parameters(),
                                  cfg.learning_rate, cfg.weight_decay,
                                  cfg.grad_clip)
        self.fns = make_train_fns(self.model, bc, mc,
                                  dagr.graph_static_config(cfg), self.opt,
                                  dev)
        self.gen = torch.Generator(device=dev).manual_seed(seed)
        self.n = 0
        head = dict(self.model.head.named_parameters())
        self.leaves = {HEAD_KEYS[k]: p for k, p in head.items()}
        before = {k: p.detach().clone() for k, p in self.leaves.items()}
        self.losses = []
        for i in range(mix["batches"]):
            out = self.step()
            if i < FOLLOWED:
                self.losses.append(float(out["loss"]))
            if i == 0:
                st = self.opt.inner.state
                b1 = self.opt.inner.param_groups[0]["betas"][0]
                # an optimizer that took no step holds no moment: zero
                self.first_grad = {
                    k: st.get(p, {}).get("exp_avg", torch.zeros_like(p))
                    .detach().clone() / (1.0 - b1)
                    for k, p in self.leaves.items()}
            if i == FOLLOWED - 1:
                self.change = {k: p.detach() - before[k]
                               for k, p in self.leaves.items()}
        if self.on_card:
            torch.cuda.synchronize()

    def step(self, spans: bool = False):
        """One training step on the next staged batch of the cycle."""
        sp = tr.span if spans else (lambda _n: contextlib.nullcontext())
        j = int(self.order[self.n % len(self.order)])
        self.n += 1
        with sp("train_step"):
            return self.fns.train_step(self.staged[j], self.gen)

    def followed(self):
        """The staged batches of the first steps, in their order."""
        return [int(j) for j in self.order[:FOLLOWED]]

    def window(self, seconds: float) -> dict:
        records, times, flops, items = [], [], 0.0, 0
        t0, c0 = time.perf_counter(), time.thread_time()
        deadline = t0 + seconds
        while True:
            j = int(self.order[self.n % len(self.order)])
            ts = time.perf_counter()
            out = self.step()
            times.append(time.perf_counter() - ts)
            records.append((out["finite"], out["loss"].detach()))
            items += self.cfg.batch_size
            flops += step_flops(self.geo, int(self.staged[j].pos.shape[1]))
            if time.perf_counter() >= deadline:
                break
        window_s = time.perf_counter() - t0
        cpu = (time.thread_time() - c0) / window_s
        core.spread_line("step", times, cpu)
        return {"records": records, "train_items_per_s": items / window_s,
                "mfu_pct": 100.0 * flops / window_s / PEAK_BF16}

    def traced(self, n: int) -> dict:
        with tr.KernelCalls() as calls, tr.traced() as prof:
            for _ in range(n):
                self.step(spans=True)
        return tr.reduce(prof, n, calls.bounds())

    def close(self) -> None:
        del self.model, self.opt, self.fns, self.staged, self.leaves
        if self.on_card:
            self._torch.cuda.empty_cache()


def _norm_gap(got: dict, ref: dict, keys) -> float:
    """The worst leaf's gap of norms over the larger of its reference norm
    and the median leaf's."""
    rn = {k: float(ref[k].norm()) for k in keys}
    med = float(np.median(list(rn.values())))
    return max(abs(float(got[k].norm()) - rn[k]) / max(rn[k], med, 1e-30)
               for k in keys)


def reference(s: Session, tf32: bool = False):
    """The reference trained on the followed steps' batches, collated again
    from the same sequences, with the program's dropout seed: ``(losses,
    first clipped gradient, head leaves after the steps)``; with ``tf32``
    its f32 products in TF32 (the control)."""
    import torch
    dev = next(iter(s.sd.values())).device
    byname = {q["name"]: q for q in s.seqs}
    batches = [rmodel.to_device(rdata.collate(
        [rdata.cut(byname[n], f - 1, s.geo)
         for n, f in zip(*s.metas[j])], s.geo), dev) for j in s.followed()]
    rmodel.strict_f32()
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    gen = torch.Generator(device=dev).manual_seed(s.seed)
    out = rtrain.train(s.sd, s.geo, batches, gen, s.cfg.learning_rate,
                       s.cfg.weight_decay, s.cfg.grad_clip)
    rmodel.strict_f32()
    return out


def gaps(s: Session, losses, first, change, ref) -> dict:
    """The three numbers of ``(losses, first, change)`` (a run's followed
    steps: their losses, the first gradient, each leaf's change over them)
    against the reference's ``ref``: the worst step's relative loss
    gap, the worst leaf's gap of first-gradient norms and of the change
    over the steps; leaves whose reference gradient is under a thousandth
    of the median leaf's are left out of the change."""
    r_losses, r_first, r_after = ref
    gn = {k: float(r_first[k].norm()) for k in r_first}
    med = float(np.median(list(gn.values())))
    moved = [k for k in r_first if gn[k] >= 1e-3 * med]
    init = {k: v for k, v in s.sd.items() if rtrain.is_head(k)}
    return {
        "loss_gap": max(abs(a - b) / max(abs(b), 1e-30)
                        for a, b in zip(losses, r_losses)),
        "grad_gap": _norm_gap(first, r_first, list(r_first)),
        "change_gap": _norm_gap(change,
                                {k: r_after[k] - init[k] for k in moved},
                                moved),
        "left_out": sorted(set(r_first) - set(moved))}


KEYS = ("loss_gap", "grad_gap", "change_gap")


def _judge(s: Session, records):
    got = gaps(s, s.losses, s.first_grad, s.change, reference(s))
    failed = sum(1 for ok, loss in records
                 if not ok or not np.isfinite(float(loss)))
    return failed, {k: got[k] for k in KEYS}


def run(cell, seed: int, seconds: float, trace: bool, dev,
        t_start: float) -> None:
    drive(cell, Session(cell, seed, dev), seconds, trace, t_start, _judge)


def calibrate(cell, seed: int, seconds: float, dev) -> dict:
    """One seed's readings: the program's three numbers against the f32
    reference, and the control's (the reference with its f32 products in
    TF32, in the program's place)."""
    s = Session(cell, seed, dev)
    s.window(seconds)
    s.close()
    ref = reference(s)
    prog = gaps(s, s.losses, s.first_grad, s.change, ref)
    c_losses, c_first, c_after = reference(s, tf32=True)
    init = {k: v for k, v in s.sd.items() if rtrain.is_head(k)}
    ctrl = gaps(s, c_losses, c_first,
                {k: c_after[k] - init[k] for k in init}, ref)
    return {"program": [prog[k] for k in KEYS],
            "control": [ctrl[k] for k in KEYS],
            "left_out": prog["left_out"]}
