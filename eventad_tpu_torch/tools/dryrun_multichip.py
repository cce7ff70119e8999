"""The four multi-process paths of the port on ``N`` processes
(counterpart of ``__graft_entry__.dryrun_multichip``):

    python -m eventad_tpu_torch.tools.dryrun_multichip 4
    python -m eventad_tpu_torch.tools.dryrun_multichip 4 --device cuda \
        --geometry operating      # N cards, NCCL

1. data-parallel head training on a ``(N/2)x2`` mesh (``N`` x 1 for odd
   ``N``): two steps on one batch, the second loss below the first;
2. data-parallel evaluation on the same mesh: the logits within 1e-4 of
   one process's, valid slots and labels equal;
3. the detector's dp x tp step on that mesh when its model axis is 2: at
   least 10 weights sharded over "model", two steps at the rate 3e-4, the
   loss falling;
4. event-axis sequence parallelism over all ``N`` ranks: ``out4`` within
   1e-5 of the one-rank run of the same function.

Each segment is a function of this module run on every rank through
``parallel.launch.spawn`` (``*_case``); called without a mesh the same
function runs the single-process path (here in this process, on the first
card with ``--device cuda``), which the segment and the tests hold the
ranks' results against.  ``--geometry fixture`` (96x72, a few hundred
events, the default) or ``operating`` (360x240, 16 384 events an item,
ResNet-50).  On a card TF32 is off, as in ``chip_smoke.py``: cuDNN's
default TF32 picks other algorithms for a rank's 2 items than for 8 and
moves the logits by ~5e-3 of their scale.  Prints one ``dryrun_multichip
ok:`` line and, beside it, the first steps' differences from one process
as JSON (``{"first_step": ...}``).
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import Config
from ..data.synthetic import make_synthetic_batch
from ..models.dagr import graph_static_config, init_model
from ..models.detector import init_detector
from ..parallel.launch import spawn
from ..parallel.mesh import data_size, make_mesh, shard_batch
from ..parallel.seq_shard import seq_sharded_features
from ..parallel.sharding import shard_params, sharded_init
from ..parallel.train_step import make_optimizer, make_train_fns
from ..utils.ema import ema_init
from ..utils.schedules import make_detector_optimizer

_MOD = "eventad_tpu_torch.tools.dryrun_multichip"


def fixture_config(batch_size: int, n_events: int, use_image: bool = False,
                   lookback: int = 256, **kw) -> Config:
    """The fixture geometry (96x72), or ``kw``'s ``Config`` fields."""
    return Config(**{**dict(width=96, height=72, scale=1), **kw},
                  batch_size=batch_size, use_image=use_image,
                  event_buckets=(n_events,), graph_lookback=lookback)


def _mesh(spec):
    return None if spec is None else make_mesh(spec)


def _device(device: str) -> torch.device:
    """``device``, on a card the rank's current one, with TF32 off."""
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def head_case(mesh: str = None, batch_per_rank: int = 2,
              n_events: int = 1024, use_image: bool = False, seed: int = 0,
              dropout: bool = True, steps: int = 1, weights: str = None,
              lookback: int = 256, device: str = "cpu", **kw) -> dict:
    """The head's eval step, then ``steps`` train steps on one batch (the
    same batch on every step, dropout from one generator), on mesh
    ``mesh`` (this rank's block) or in one process (``mesh`` None, the
    whole batch), on ``device``; ``kw``: other ``Config`` fields.
    ``weights``: a ``model.state_dict()`` file to start from.  Returns the
    losses, the eval outputs, the first step's head gradients (after the
    clip), the head's parameters and the model's buffers after the steps,
    on the CPU."""
    dev = _device(device)
    m = _mesh(mesh)
    d = 1 if m is None else data_size(m)
    cfg = fixture_config(batch_per_rank * d, n_events, use_image, lookback,
                         **kw)
    model, bc, mc = init_model(cfg, torch.Generator().manual_seed(seed),
                               dev)
    if weights:
        model.load_state_dict(torch.load(weights, weights_only=True))
    if not dropout:
        mc = mc._replace(dropout=0.0)
    opt = make_optimizer(model.head.parameters(), cfg.learning_rate,
                         cfg.weight_decay, cfg.grad_clip)
    fns = make_train_fns(model, bc, mc, graph_static_config(cfg), opt,
                         dev, mesh=m)
    batch = make_synthetic_batch(cfg, seed=seed + 3)
    if m is not None:
        batch = shard_batch(batch, m)
    with torch.no_grad():
        logits, valid, labels, _loss, _nv = fns.eval_step(batch)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    losses, n_valid, grads = [], 0, None
    for _ in range(steps):
        out = fns.train_step(batch, gen)
        if not out["finite"]:
            raise AssertionError("non-finite head train step")
        losses.append(float(out["loss"]))
        n_valid = int(out["n_valid"])
        if grads is None:
            grads = {k: p.grad.cpu() for k, p in
                     model.head.named_parameters()}
    return dict(losses=losses, n_valid=n_valid, grads=grads,
                eval=tuple(t.detach().cpu() for t in (logits, valid,
                                                       labels)),
                head={k: v.detach().cpu()
                      for k, v in model.head.named_parameters()},
                buffers={k: v.cpu() for k, v in model.named_buffers()})


def detector_case(mesh: str = None, batch_per_rank: int = 2,
                  n_events: int = 512, seed: int = 0, steps: int = 1,
                  lookback: int = 128, lr: float = 1e-3,
                  use_image: bool = False, device: str = "cpu",
                  **kw) -> dict:
    """``steps`` detector train steps on one batch, dp x tp on mesh
    ``mesh`` or in one process (AdamW at rate ``lr`` after the clip of
    ``Config.clip``), on ``device``; ``kw``: other ``Config`` fields.
    Returns the batch's losses per step, the number of weights sharded
    over "model", and, whole and on the CPU, each step's gradients (after
    the clip), the parameters before the steps and after each step, the
    EMA after each step, and the detector's state (parameters and running
    statistics, and the latter alone as ``buffers``) and optimizer state
    after the steps."""
    from ..train_detector import anchor_geometry, make_detector_train_step
    dev = _device(device)
    m = _mesh(mesh)
    d = 1 if m is None else data_size(m)
    cfg = fixture_config(batch_per_rank * d, n_events, use_image, lookback,
                         **kw)
    detector, bc = init_detector(cfg, torch.Generator().manual_seed(seed),
                                 dev)
    sharded = None if m is None else shard_params(detector, m)
    params = (list(detector.parameters()) if sharded is None
              else sharded.locals)
    opt = make_detector_optimizer(
        params, cfg.optimizer, lambda step: lr, cfg.weight_decay,
        cfg.clip, grad_norm=None if sharded is None else sharded.grad_norm)
    ema = sharded_init(ema_init, sharded, detector.parameters())
    step = make_detector_train_step(detector, cfg, bc, opt,
                                    anchor_geometry(bc, dev), sharded)
    batch = make_synthetic_batch(cfg, seed=seed + 5).to(dev)
    if m is not None:
        batch = shard_batch(batch, m)

    def whole(values):
        values = values if sharded is None else sharded.full_values(values)
        return [v.detach().clone().cpu() for v in values]
    losses, grads, emas = [], [], []
    values = [whole(params)]
    for _ in range(steps):
        ema, lo = step(batch, ema)
        losses.append({k: float(v) for k, v in lo.items()})
        grads.append(whole([p.grad for p in params]))
        values.append(whole(params))
        emas.append(whole(ema.params))
    opt_state = opt.state_dict()
    if sharded is not None:
        sharded.gather()
        opt_state = sharded.full_optimizer_state(opt)

    def cpu(tree):
        if isinstance(tree, dict):
            return {k: cpu(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(cpu(v) for v in tree)
        return tree.detach().cpu() if torch.is_tensor(tree) else tree
    return dict(losses=losses, grads=grads, params=values, ema=emas,
                optimizer=cpu(opt_state),
                n_sharded=0 if sharded is None else sharded.n_sharded,
                state=cpu(detector.state_dict()),
                buffers={k: v.cpu() for k, v in detector.named_buffers()})


def stream(n: int, width: int, height: int, seed: int = 0,
           t_span: int = 100_000):
    """A time-sorted synthetic stream ``(pos [n, 3] int32, polarity [n])``
    (the JAX package's ``tests/test_seq_shard.py`` recipe)."""
    rng = np.random.RandomState(seed)
    pos = np.zeros((n, 3), np.int32)
    pos[:, 0] = rng.randint(0, width, n)
    pos[:, 1] = rng.randint(0, height, n)
    pos[:, 2] = 1_000_000 + np.sort(rng.randint(0, t_span, n))
    pol = rng.choice([-1.0, 1.0], n).astype(np.float32)
    return torch.from_numpy(pos), torch.from_numpy(pol)


def seq_case(mesh: str = None, n: int = 1024, lookback: int = 64,
             use_image: bool = False, seed: int = 1, device: str = "cpu",
             **kw) -> dict:
    """``seq_sharded_features`` of one synthetic stream over mesh ``mesh``
    (``"D"``), or over a one-rank mesh of this process's own group where
    ``mesh`` is None, on ``device``; ``kw``: other ``Config`` fields.
    Returns ``(x, node_mask)`` of ``out3`` and ``out4`` on the CPU."""
    from ..streaming import incremental as inc
    dev = _device(device)
    cfg = fixture_config(1, n, use_image, lookback, **kw)
    model, bc, mc = init_model(cfg, torch.Generator().manual_seed(seed),
                               dev)
    pos, pol = stream(n, cfg.model_width, cfg.model_height, seed)
    feats = None
    if use_image:
        rng = np.random.RandomState(seed + 1)
        img = torch.from_numpy(rng.rand(cfg.model_height, cfg.model_width,
                                        3).astype(np.float32))
        st = inc.update_image(model, inc.init_incremental_state(
            n, bc, mc, cfg.max_neighbors, dev), img.to(dev))
        feats = st.image_feats
    outs = seq_sharded_features(model, bc, graph_static_config(cfg),
                                pos.to(dev), pol.to(dev),
                                torch.ones(n, dtype=torch.bool, device=dev),
                                feats, make_mesh(mesh or "1"))
    return [(g.x.cpu(), g.node_mask.cpu()) for g in outs]


def _rel(a, b) -> float:
    return float((a - b).abs().max() / (b.abs().max() + 1e-6))


def _worst(got, want, floor=1e-12) -> float:
    """The worst leaf's difference of its scale (at least ``floor``: a
    bias behind a batch-statistics BN has gradient 0 up to rounding)."""
    return max(float((a - b).abs().max()) / max(float(b.abs().max()), floor)
               for a, b in zip(got, want))


GEOMETRIES = {
    # head / detector / seq SP: Config fields, events an item, lookback
    "fixture": (dict(), 512, 128, 1024, 64),
    "operating": (dict(width=1080, height=720, scale=3), 16384, 1024,
                  None, 1024),
}


def main(argv=None) -> str:
    import argparse
    import json
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n", nargs="?", type=int, default=4)
    p.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    p.add_argument("--geometry", default="fixture", choices=GEOMETRIES)
    a = p.parse_args(sys.argv[1:] if argv is None else argv)
    n = a.n
    geo, n_ev, lb, sp_n, sp_lb = GEOMETRIES[a.geometry]
    dp, mp = (n // 2, 2) if n % 2 == 0 and n > 2 else (n, 1)
    spec = f"{dp}x{mp}"
    common = dict(geo, device=a.device, n_events=n_ev, lookback=lb)

    def run(fn, world, **kw):
        return spawn(f"{_MOD}:{fn}", world, kwargs=kw, device=a.device)

    # 1-2: the head's data-parallel train and eval steps
    kw = dict(common, batch_per_rank=1, use_image=True, steps=2)
    ranks = run("head_case", n, mesh=spec, **kw)
    one = head_case(None, **dict(kw, batch_per_rank=dp))
    loss0, loss1 = ranks[0]["losses"]
    if not (np.isfinite([loss0, loss1]).all() and loss1 < loss0):
        raise AssertionError(f"loss did not decrease: {loss0} -> {loss1}")
    (lg, v, lb_), (lg1, v1, lb1) = ranks[0]["eval"], one["eval"]
    if not (torch.equal(v, v1) and torch.equal(lb_, lb1)):
        raise AssertionError("dp eval: valid slots or labels differ")
    eval_rel = _rel(lg, lg1)
    if not eval_rel < 1e-4:
        raise AssertionError(f"dp eval logits diverge: {eval_rel}")
    first = dict(head_loss_rel=abs(loss0 - one["losses"][0])
                 / abs(one["losses"][0]),
                 head_grad_worst=_worst(ranks[0]["grads"].values(),
                                        one["grads"].values()),
                 eval_rel=eval_rel)
    note = (f"mesh={spec} loss0={loss0:.4f} loss1={loss1:.4f} "
            f"n_valid={ranks[0]['n_valid']}")
    # 3: dp x tp detector training
    if mp > 1:
        # at the rate 1e-3 the second loss of the fixture's batch rises in
        # one process too (Adam's first steps move every weight by ~lr)
        kw = dict(common, batch_per_rank=1, steps=2, lr=3e-4)
        det = run("detector_case", n, mesh=spec, **kw)[0]
        det1 = detector_case(None, **dict(kw, batch_per_rank=dp))
        ns = det["n_sharded"]
        if ns < 10:
            raise AssertionError(f"only {ns} weights sharded over 'model'")
        l0, l1 = (x["total"] for x in det["losses"])
        if not (np.isfinite([l0, l1]).all() and l1 < l0):
            raise AssertionError(f"detector-tp loss did not decrease: "
                                 f"{l0} -> {l1}")
        first.update(
            detector_loss_rel=abs(l0 - det1["losses"][0]["total"])
            / abs(det1["losses"][0]["total"]),
            detector_grad_worst=_worst(det["grads"][0], det1["grads"][0],
                                       1e-4),
            detector_sharded=ns)
        note += (f" detector_tp: sharded={ns} loss0={l0:.4f} "
                 f"loss1={l1:.4f}")
    # 4: sequence parallelism over every rank against one rank
    kw = dict(geo, device=a.device, n=sp_n or n_ev * n, lookback=sp_lb)
    sp = run("seq_case", n, mesh=str(n), **kw)[0]
    sp1 = run("seq_case", 1, **kw)[0]
    sp_rel = _rel(sp[1][0], sp1[1][0])
    if not sp_rel < 1e-5:
        raise AssertionError(f"seq-sp out4 diverges: {sp_rel}")
    first["seq_sp_out4_rel"] = sp_rel
    note += (f" seq_sp: devices={n} out4_rel={sp_rel:.1e}"
             f" dp_eval: logits_rel={eval_rel:.1e}")
    line = f"dryrun_multichip ok: {note}"
    print(line, flush=True)
    print(json.dumps({"first_step": first, "device": a.device,
                      "geometry": a.geometry, "processes": n}), flush=True)
    return line


if __name__ == "__main__":
    main()
