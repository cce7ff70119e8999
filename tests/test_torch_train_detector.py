"""Detector training, the slice as a whole: the port's training step
(``train_detector.make_detector_train_step``) against the JAX package's
(the root ``train_detector.py``'s ``train_step``: ``value_and_grad`` of the
simOTA loss on the decoded outputs, the clipped AdamW on the YOLOX
schedule, the EMA) from the same weights on the same batch, at the
geometry of ``tests/test_detector_bf16.py`` (96 x 72, batch 2, 1 024
events, lookback 256, 3 boxes per item); then the entry modules on the
CPU.  The JAX steps are compiled once per dtype, in one module-scoped run."""
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eventad_tpu.config import Config as JaxConfig
from eventad_tpu.data.synthetic import make_synthetic_batch as jax_batch
from eventad_tpu.models import backbone as jbb
from eventad_tpu.models import detector as jdet
from eventad_tpu.models import yolox_loss as jloss
from eventad_tpu.utils import ema as jema
from eventad_tpu.utils import schedules as jsched
from eventad_tpu_torch import test_detector as det_eval
from eventad_tpu_torch import train_detector as tdt
from eventad_tpu_torch.config import Config
from eventad_tpu_torch.data.synthetic import make_synthetic_batch
from eventad_tpu_torch.models import backbone as bb
from eventad_tpu_torch.models import detector as tdet
from eventad_tpu_torch.models.convert import (export_detector_grads,
                                              export_detector_state,
                                              load_detector_state)
from eventad_tpu_torch.models.detector import init_detector
from eventad_tpu_torch.ops.pooling import max_pool_margin
from eventad_tpu_torch.utils.checkpoint import load_detector_checkpoint
from eventad_tpu_torch.utils.ema import ema_init, ema_weights
from eventad_tpu_torch.utils.schedules import (make_detector_optimizer,
                                               yolox_schedule)
from test_torch_detector import _seeded_detector

import _torch_threads  # noqa: F401  (one intra-op thread)

KW = dict(batch_size=2, width=96, height=72, scale=1, use_image=True,
          event_buckets=(1024,), graph_lookback=256)
BOXES = 3
# the root script's schedule with one batch an epoch and three epochs: the
# first update at rate 0, then the base rate, then the cosine
SCHED = dict(base_lr=1e-3, warmup_steps=1, total_steps=3)
OPT = dict(kind="adam", weight_decay=1e-5, clip=0.1)
STEPS = 3
LOSS_TOL = 1e-5       # relative, f32 both sides
GRAD_TOL = 1e-4       # of each gradient leaf's scale
# a leaf's scale is at least this: the loss's gradients reach ~1, and a bias
# that a batch-statistics BN follows has gradient 0 up to rounding (~1e-9)
SCALE_FLOOR = 1e-5
# A max-pooling cell whose two largest entries of a channel lie within
# NEAR_TIE of each other (relative, not equal) routes its cotangent to
# whichever entry f32 rounding makes the larger, and the two packages'
# convolutions round differently, so either can win.  The leaves whose
# gradient passes through such a cell (the backbone layers below it, the
# image remaps pooled into it and the ResNet trunk under them) move by a
# few hundredths of their scale when a route flips: they are held to
# NEAR_TIE_TOL; every other leaf (the upper levels, the heads) is held to
# GRAD_TOL, and the whole gradient to GRAD_TOL of its norm.
NEAR_TIE = 2e-5
NEAR_TIE_TOL = 5e-2
STATE_TOL = 1e-5      # of each leaf's scale (at least 1)
LATER_LOSS_TOL = 1e-4  # relative, the losses of steps 2 and 3
# the parameters, EMA and running statistics after two updates at the base
# rate 1e-3, of each leaf's scale (at least 1): Adam divides each gradient
# by its own root mean square, so where two gradients differ by their
# rounding (a leaf near 0, a near tie) the update moves by up to the rate
LATER_STATE_TOL = 3e-3
BF16_LOSS_TOL = 0.01  # relative, bf16 both sides (tests/test_detector_bf16)


def _flat(tree, prefix=""):
    """``{path: array}`` of a tree of named tuples or namespaces, dicts,
    sequences and arrays, the paths as ``jax.tree_util.keystr`` writes
    them; ``None`` is no leaf."""
    if tree is None:
        return {}
    if isinstance(tree, SimpleNamespace) or hasattr(tree, "_fields"):
        items = (vars(tree).items() if isinstance(tree, SimpleNamespace)
                 else tree._asdict().items())
        return {k: v for name, sub in items
                for k, v in _flat(sub, f"{prefix}.{name}").items()}
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}['{name}']").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{prefix}[{i}]").items()}
    return {prefix: np.asarray(tree)}


def _errors(got, want, floor):
    """``{path: error}``, each leaf's worst error relative to its scale
    (at least ``floor``)."""
    got, want = _flat(got), _flat(want)
    assert set(got) == set(want), set(got) ^ set(want)
    return {k: np.abs(got[k] - want[k]).max()
            / max(np.abs(want[k]).max(), floor) for k in want}


def _worst(got, want, floor=1e-12):
    """The worst leaf error relative to its leaf's scale, and its path."""
    errs = _errors(got, want, floor)
    k = max(errs, key=errs.get)
    return errs[k], k


def _near_tie_pools(pools):
    """The levels (1-4) whose max-pooling has a near tie: a cell in which
    the two largest distinct entries of a channel differ by less than
    ``NEAR_TIE`` of the larger.  ``pools``: the recorded ``(x, pos,
    node_mask, batch, grid, aggr)`` of each pooling."""
    return {level for level, (*t, grid, aggr) in enumerate(pools, start=1)
            if aggr == "max" and max_pool_margin(
                *t, grid=grid, batch_size=KW["batch_size"]) < NEAR_TIE}


def _jax_step(dtype, params, state):
    """The root script's ``train_step`` in ``dtype``, compiled ahead of
    time for ``params`` and ``state``; and its optimizer."""
    jcfg = JaxConfig(**KW, compute_dtype=dtype)
    jbc = jbb.make_backbone_config(jcfg)
    grids = [jbc.grids[2], jbc.grids[3]]
    geom = jloss.make_anchor_geometry(
        grids, [int(round(jbc.height / g[1])) for g in grids])
    opt = jsched.make_detector_optimizer(
        OPT["kind"], jsched.yolox_schedule(**SCHED), OPT["weight_decay"],
        OPT["clip"])
    batch = jax.tree.map(jnp.asarray, jax_batch(jcfg, boxes_per_item=BOXES)
                         ._replace(pool_tables=None, search_starts=None,
                                   image_s2d=None))

    def loss_fn(params, state):
        _dets, decoded, new_state = jdet.detector_forward(
            params, state, batch, jcfg, jbc, training=True)
        p = jnp.clip(decoded[..., 4:], 1e-6, 1 - 1e-6)
        logits = decoded.at[..., 4:].set(jnp.log(p) - jnp.log1p(-p))
        tgt, tmask = jloss.convert_to_training_format(batch.bbox,
                                                      batch.bbox_mask)
        losses = jloss.yolox_loss(logits, tgt, tmask, geom, l1_weight=0.0)
        return losses["total"], (losses, new_state)

    def train_step(params, state, opt_state, ema):
        (_, (losses, new_state)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, state)
        updates, new_opt = opt.update(grads, opt_state, params)
        new_params = optax.apply_updates(params, updates)
        return (new_params, new_state, new_opt,
                jema.ema_update(ema, new_params), losses, grads)

    return jax.jit(train_step).lower(
        params, state, opt.init(params), jema.ema_init(params)).compile(), opt


def _jax_run(compiled, params, state, n_steps):
    step, opt = compiled
    opt_state, ema, out = opt.init(params), jema.ema_init(params), []
    for _ in range(n_steps):
        params, state, opt_state, ema, losses, grads = step(
            params, state, opt_state, ema)
        out.append(jax.tree.map(np.asarray, dict(
            params=params, state=state, ema=ema.params, grads=grads,
            losses=losses)))
    return out


def _torch_run(dtype, params, state, n_steps, grads_too=True):
    cfg = Config(**KW, compute_dtype=dtype)
    detector, bc = init_detector(cfg, torch.Generator().manual_seed(1),
                                 "cpu")
    load_detector_state(detector, params, state)
    optimizer = make_detector_optimizer(
        detector.parameters(), OPT["kind"], yolox_schedule(**SCHED),
        OPT["weight_decay"], OPT["clip"])
    ema = ema_init(detector.parameters())
    step = tdt.make_detector_train_step(detector, cfg, bc, optimizer,
                                        tdt.anchor_geometry(bc))
    batch = make_synthetic_batch(cfg, boxes_per_item=BOXES)
    # the inputs of every pooling of the first forward (f32)
    pools, pool_graph = [], bb.pool_graph

    def recorded_pool(x, pos, nbr, nbr_mask, node_mask, batch_ids, **kw):
        if grads_too and len(pools) < 4:
            pools.append((x.detach(), pos, node_mask, batch_ids,
                          kw["grid"], kw["aggr"]))
        return pool_graph(x, pos, nbr, nbr_mask, node_mask, batch_ids, **kw)
    # the gradients as the backward left them, before the clip scales them
    grads, update = [], optimizer.step

    def step_and_keep():
        if grads_too:
            grads.append(export_detector_grads(detector))
        update()
    optimizer.step = step_and_keep
    out = []
    for i in range(n_steps):
        bb.pool_graph = recorded_pool
        try:
            ema, losses = step(batch, ema)
        finally:
            bb.pool_graph = pool_graph
        p, s = export_detector_state(detector)
        with torch.no_grad(), ema_weights(detector.parameters(), ema):
            ema_tree, _ = export_detector_state(detector)
        out.append(dict(params=p, state=s, losses=losses, ema=ema_tree,
                        grads=grads[i] if grads_too else None, pools=pools))
    return out, detector, ema


@pytest.fixture(scope="module")
def runs():
    """Both dtypes' JAX steps compile in two threads while the port's runs
    go on in this one; then the JAX steps run."""
    params, state = _seeded_detector(JaxConfig(**KW))
    np_p, np_s = (jax.tree.map(np.asarray, t) for t in (params, state))
    with ThreadPoolExecutor(2) as pool:
        steps = {dt: pool.submit(_jax_step, dt, params, state)
                 for dt in ("float32", "bfloat16")}
        out = dict(torch32=_torch_run("float32", np_p, np_s, STEPS),
                   torch16=_torch_run("bfloat16", np_p, np_s, 2,
                                      grads_too=False),
                   init=(np_p, np_s))
        out["jax32"] = _jax_run(steps["float32"].result(), params, state,
                                STEPS)
        out["jax16"] = _jax_run(steps["bfloat16"].result(), params, state, 2)
    return out


def test_first_step_f32_matches_jax(runs):
    want, got = runs["jax32"][0], runs["torch32"][0][0]
    for k, v in want["losses"].items():
        np.testing.assert_allclose(float(got["losses"][k]), float(v),
                                   rtol=LOSS_TOL, atol=1e-7, err_msg=k)
    assert float(got["losses"]["num_fg"]) >= 6
    # every leaf against JAX's; the ones behind a max-pooling near tie
    # within NEAR_TIE_TOL (see its comment), the others within GRAD_TOL
    errs = _errors(got["grads"], want["grads"], SCALE_FLOOR)
    tied = _near_tie_pools(got["pools"])
    assert len(got["pools"]) == 4 and tied <= {1, 2, 3}
    top = max(tied, default=0)
    behind = tuple(f".dagr.backbone.layers[{i}]" for i in range(top)) \
        + tuple(f".dagr.cnn['feature_dconv'][{i}]" for i in range(top + 1)) \
        + ((".dagr.cnn['resnet']",) if top else ())
    loose = {k: e for k, e in errs.items() if k.startswith(behind)}
    strict = {k: e for k, e in errs.items() if k not in loose}
    worst = max(strict, key=strict.get)
    assert strict[worst] < GRAD_TOL, (worst, strict[worst], tied)
    assert len(strict) > 100      # the upper levels, the heads
    g, w = _flat(got["grads"]), _flat(want["grads"])
    dist = np.sqrt(sum(((g[k] - w[k]) ** 2).sum() for k in w)
                   / sum((w[k] ** 2).sum() for k in w))
    assert dist < GRAD_TOL, dist
    if loose:
        worst = max(loose, key=loose.get)
        assert loose[worst] < NEAR_TIE_TOL, (worst, loose[worst], tied)
    # the hybrid fusion detaches the CNN head's maps: it and the ResNet's
    # two output remaps get zero gradients; the ResNet's weights and BN
    # parameters (its BN in eval mode) and the backbone's get theirs
    flat = _flat(got["grads"])
    for k, v in flat.items():
        detached = k.startswith((".head.cnn", ".dagr.cnn['output_dconv']"))
        if detached or k.startswith((".dagr.cnn['resnet']",
                                     ".dagr.backbone.layers")) \
                and k.endswith(("conv.weight", "]")):
            assert v.any() != detached, k
    # the first update runs at rate 0 (the parameters and so the EMA stay
    # where they were); the BN running statistics moved once
    for key in ("params", "ema", "state"):
        err, where = _worst(got[key], want[key], floor=1.0)
        assert err < STATE_TOL, (key, err, where)
    moved, _ = _worst(got["state"], runs["init"][1], floor=1.0)
    assert moved > 1e-3


def test_three_steps_f32_track_jax(runs):
    want, (got, _, ema) = runs["jax32"], runs["torch32"]
    losses = [[float(r["losses"]["total"]) for r in rs] for rs in (got, want)]
    np.testing.assert_allclose(losses[0], losses[1], rtol=LATER_LOSS_TOL)
    assert losses[0][-1] < losses[0][0]
    assert ema.updates == STEPS
    # the parameters and the EMA after two updates at the base rate, leaf
    # for leaf against the leaf's scale
    for key in ("params", "ema", "state"):
        err, where = _worst(got[-1][key], want[-1][key], floor=1.0)
        assert err < LATER_STATE_TOL, (key, err, where)
    moved, _ = _worst(got[-1]["ema"], runs["init"][0], floor=1.0)
    assert moved > 1e-4


def test_bf16_losses_within_reference_band_and_master_weights_f32(runs):
    want, (got, detector, ema) = runs["jax16"], runs["torch16"]
    for g, w in zip(got, want):
        g, w = float(g["losses"]["total"]), float(w["losses"]["total"])
        assert abs(g - w) / abs(w) < BF16_LOSS_TOL, (g, w)
    assert all(p.dtype == torch.float32 for p in detector.parameters())
    assert all(b.dtype == torch.float32 for b in detector.buffers())
    assert all(e.dtype == torch.float32 for e in ema.params)


def test_training_step_runs_no_nms(monkeypatch):
    cfg = Config(**KW)
    detector, bc = init_detector(cfg, torch.Generator().manual_seed(2),
                                 "cpu")

    def refuse(*a, **kw):
        raise AssertionError("the training step ran the NMS")
    monkeypatch.setattr(tdet, "postprocess", refuse)
    optimizer = make_detector_optimizer(
        detector.parameters(), "sgd", yolox_schedule(**SCHED), 0.0, 0.1)
    step = tdt.make_detector_train_step(detector, cfg, bc, optimizer,
                                        tdt.anchor_geometry(bc))
    ema, losses = step(make_synthetic_batch(cfg, boxes_per_item=BOXES),
                       ema_init(detector.parameters()))
    assert torch.isfinite(losses["total"]) and optimizer.count == 1


GEOM_ARGS = ["--device", "cpu", "--width", "96", "--height", "72",
             "--scale", "1", "--batch_size", "2", "--event_buckets", "1024",
             "--graph_lookback", "256", "--val_batches", "1"]


def test_entry_modules_train_and_evaluate_on_the_cpu(tmp_path, capsys):
    res = tdt.main(GEOM_ARGS + [
        "--epochs", "2", "--no_aug_epochs", "1", "--train_batches", "1",
        "--output_dir", str(tmp_path)])
    path = res["checkpoint"]
    assert path.name == "detector_latest.pt" and path.exists()
    assert [h["l1_weight"] for h in res["history"]] == [0.0, 1.0]
    assert res["history"][1]["l1"] > 0 and res["ema"].updates == 2
    assert res["optimizer"].count == 2
    out = capsys.readouterr().out
    assert "epoch 1: loss" in out and "mAP" in out
    # test_detector reads the file and evaluates its EMA weights
    cfg = Config(**KW)
    fresh, _ = init_detector(cfg, torch.Generator().manual_seed(9), "cpu")
    obj = load_detector_checkpoint(path, fresh, "cpu")
    assert obj["extra"]["epoch"] == 1 and "mAP" in obj["extra"]
    for p, e in zip(fresh.parameters(), res["ema"].params):
        assert torch.equal(p, e)
    for b, t in zip(fresh.buffers(), res["detector"].buffers()):
        assert torch.equal(b, t)
    metrics = det_eval.main(GEOM_ARGS + ["--test_checkpoint", str(path)])
    assert set(metrics) == {"mAP", "mAP_50"}
    assert f"loaded {path}" in capsys.readouterr().out
