"""Detector training's pieces against the JAX package on seeded inputs: the
simOTA loss and its gradient (ties included), the YOLOX and step schedules,
the EMA, the clipped AdamW / SGD update, and the gradients that training
takes through the masked batch norm, the spline conv and the graph pooling
(max ties included)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eventad_tpu.models import yolox_loss as jloss
from eventad_tpu.ops.norm import (BatchNormParams, BatchNormState,
                                  batch_norm as jax_batch_norm)
from eventad_tpu.ops.pooling import pool_graph as jax_pool
from eventad_tpu.ops.spline_conv import (SplineConvParams,
                                         spline_conv as jax_spline_conv)
from eventad_tpu.utils import ema as jema
from eventad_tpu.utils import schedules as jsched
from eventad_tpu_torch.models import yolox_loss as tloss
from eventad_tpu_torch.ops.norm import BatchNorm, batch_norm
from eventad_tpu_torch.ops.pooling import max_pool_margin, pool_graph
from eventad_tpu_torch.ops.spline_conv import SplineConv, spline_conv
from eventad_tpu_torch.utils import ema as tema
from eventad_tpu_torch.utils import schedules as tsched

import _torch_threads  # noqa: F401  (one intra-op thread)

# the two detection scales of the 96 x 72 fixture geometry
GRIDS, STRIDES = [(14, 10), (7, 5)], [7, 14]
GRAD_TOL = 1e-5       # of the gradient's scale, f32 both sides


def _rel(got, want):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def _loss_case(rng, tied):
    """Decoded outputs ``[2, 175, 7]`` (boxes in pixels near the anchors,
    logits) and targets ``[2, 8, 5]`` with 5 and 3 valid boxes.  ``tied``:
    anchors in groups of 3 share one output row, and image 0 holds one
    target twice, so costs tie between anchors and between targets."""
    centers = np.asarray(jloss.make_anchor_geometry(GRIDS, STRIDES).centers)
    a = centers.shape[0]
    out = np.zeros((2, a, 7), np.float32)
    out[..., :2] = centers + rng.randn(2, a, 2) * 4
    out[..., 2:4] = rng.rand(2, a, 2) * 30 + 6
    out[..., 4:] = rng.randn(2, a, 3) * 2
    if tied:
        out[:, 1::3] = out[:, 0:-1:3]
        out[:, 2::3] = out[:, 0:-2:3]
    tgt = np.zeros((2, 8, 5), np.float32)
    tgt[..., 0] = rng.randint(0, 2, (2, 8))
    tgt[..., 1] = rng.rand(2, 8) * 80 + 8
    tgt[..., 2] = rng.rand(2, 8) * 56 + 8
    tgt[..., 3:5] = rng.rand(2, 8, 2) * 24 + 8
    mask = np.zeros((2, 8), bool)
    mask[0, :5] = mask[1, :3] = True
    if tied:
        tgt[0, 1] = tgt[0, 0]
    return out, tgt, mask


@jax.jit
def _jax_loss(out, tgt, mask, l1_weight):
    def total(o):
        losses = jloss.yolox_loss(o, tgt, mask,
                                  jloss.make_anchor_geometry(GRIDS, STRIDES),
                                  l1_weight=l1_weight)
        return losses["total"], losses
    return jax.value_and_grad(total, has_aux=True)(out)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("l1_weight", [0.0, 1.0])
def test_yolox_loss_and_gradient_match_jax(tied, l1_weight):
    out, tgt, mask = _loss_case(np.random.RandomState(3 + tied), tied)
    jgeom = jloss.make_anchor_geometry(GRIDS, STRIDES)
    (_, want), jgrad = _jax_loss(*map(jnp.asarray, (out, tgt, mask)),
                                 jnp.float32(l1_weight))
    geom = tloss.make_anchor_geometry(GRIDS, STRIDES)
    np.testing.assert_array_equal(geom.centers.numpy(),
                                  np.asarray(jgeom.centers))
    o = torch.from_numpy(out).requires_grad_(True)
    got = tloss.yolox_loss(o, torch.from_numpy(tgt), torch.from_numpy(mask),
                           geom, l1_weight=l1_weight)
    got["total"].backward()
    got = {k: v.detach() for k, v in got.items()}
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    assert float(got["num_fg"]) >= 8
    assert (float(got["l1"]) > 0) == (l1_weight > 0)
    assert _rel(o.grad, jgrad) < GRAD_TOL
    # the assignment matches anchor for anchor
    matched, m_any, m_gt = tloss.simota_assign(
        o, torch.from_numpy(tgt), torch.from_numpy(mask), geom)
    assert int(matched.sum()) == int(got["num_fg"])
    assert bool((m_gt[~m_any] == 0).all())


def test_convert_to_training_format_and_logits_match_jax():
    rng = np.random.RandomState(5)
    bbox = (rng.rand(2, 6, 6) * 40).astype(np.float32)
    m = rng.rand(2, 6) > 0.4
    want, wmask = jloss.convert_to_training_format(jnp.asarray(bbox),
                                                   jnp.asarray(m))
    got, gmask = tloss.convert_to_training_format(torch.from_numpy(bbox),
                                                  torch.from_numpy(m))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
    dec = rng.rand(2, 9, 7).astype(np.float32)
    dec[0, 0, 4:] = (0.0, 1.0, 1e-6)        # clipped, and on a bound
    jd = jnp.asarray(dec)
    p = jnp.clip(jd[..., 4:], 1e-6, 1 - 1e-6)
    want = jd.at[..., 4:].set(jnp.log(p) - jnp.log1p(-p))
    np.testing.assert_allclose(
        tloss.logits_of_decoded(torch.from_numpy(dec)).numpy(),
        np.asarray(want), rtol=1e-6, atol=1e-6)


def test_schedules_and_ema_decay_match_jax():
    kw = dict(warmup_steps=5, total_steps=40, no_aug_steps=7)
    want = jsched.yolox_schedule(3e-3, **kw)
    got = tsched.yolox_schedule(3e-3, **kw)
    steps = [0, 1, 4, 5, 6, 20, 32, 33, 39, 40, 60]
    np.testing.assert_allclose([got(s) for s in steps],
                               [float(want(jnp.int32(s))) for s in steps],
                               rtol=1e-6)
    assert got(0) == 0.0 and got(33) == pytest.approx(3e-3 * 0.05)
    want = jsched.step_schedule(0.1, [3, 7], factor=0.5)
    got = tsched.step_schedule(0.1, [7, 3], factor=0.5)
    np.testing.assert_allclose([got(s) for s in range(10)],
                               [float(want(s)) for s in range(10)],
                               rtol=1e-6)
    for n in (1, 2, 2000, 100_000):
        state = jema.EMAState(jnp.zeros(()), jnp.int32(n - 1))
        d = jema.ema_update(state, jnp.ones(()))
        # ema = d * 0 + (1 - d) * 1
        np.testing.assert_allclose(1.0 - tema.ema_decay(n),
                                   float(d.params), rtol=1e-6)


def test_ema_update_matches_jax():
    rng = np.random.RandomState(6)
    leaves = [rng.randn(4, 3).astype(np.float32), rng.randn(5).astype(
        np.float32)]
    steps = [[rng.randn(*x.shape).astype(np.float32) for x in leaves]
             for _ in range(3)]
    jst = jema.ema_init([jnp.asarray(x) for x in leaves])
    tst = tema.ema_init([torch.from_numpy(x) for x in leaves])
    for new in steps:
        jst = jema.ema_update(jst, [jnp.asarray(x) for x in new])
        tst = tema.ema_update(tst, [torch.from_numpy(x) for x in new])
    assert tst.updates == int(jst.updates) == 3
    for g, w in zip(tst.params, jst.params):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    p = [torch.nn.Parameter(torch.from_numpy(x.copy())) for x in leaves]
    with tema.ema_weights(p, tst):
        assert torch.equal(p[0].detach(), tst.params[0])
    assert np.array_equal(p[1].detach().numpy(), leaves[1])


@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_detector_optimizer_matches_optax(kind):
    """Three updates from a YOLOX schedule (the first at rate 0), norms
    above and below the clip; one leaf never gets a gradient (``None`` in
    torch, zeros for optax): its moments decay and its weight decay
    applies all the same."""
    rng = np.random.RandomState(7)
    shapes = {"a": (6, 5), "b": (5,), "frozen": (3, 2)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    scales = [3.0, 0.002, 0.5]
    grads = [{k: (sc * rng.randn(*s) * (k != "frozen")).astype(np.float32)
              for k, s in shapes.items()} for sc in scales]
    sched = dict(warmup_steps=1, total_steps=3)
    jopt = jsched.make_detector_optimizer(
        kind, jsched.yolox_schedule(0.05, **sched), 0.01, 0.1)
    jp = jax.tree.map(jnp.asarray, p0)
    jstate = jopt.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    topt = tsched.make_detector_optimizer(
        tp.values(), kind, tsched.yolox_schedule(0.05, **sched), 0.01, 0.1)
    for gs in grads:
        up, jstate = jopt.update(jax.tree.map(jnp.asarray, gs), jstate, jp)
        jp = optax.apply_updates(jp, up)
        topt.zero_grad()
        for k, p in tp.items():
            if k != "frozen":
                p.grad = torch.from_numpy(gs[k].copy())
        topt.step()
    assert topt.count == 3
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    moved = np.abs(tp["frozen"].detach().numpy() - p0["frozen"]).max()
    assert (moved > 1e-5) == (kind == "adamw")    # SGD here has no decay
    assert np.abs(tp["a"].detach().numpy() - p0["a"]).max() > 1e-3


def test_batch_norm_gradient_matches_jax():
    rng = np.random.RandomState(8)
    x = (rng.randn(200, 6) * 2 + 0.5).astype(np.float32)
    mask = rng.rand(200) > 0.25
    cot = rng.randn(200, 6).astype(np.float32)
    arr = [rng.rand(6).astype(np.float32) + 0.5 for _ in range(4)]

    def f(x, scale, offset):
        y, _ = jax_batch_norm(x, jnp.asarray(mask),
                              BatchNormParams(scale, offset),
                              BatchNormState(jnp.asarray(arr[2]),
                                             jnp.asarray(arr[3])),
                              training=True)
        return (y * cot).sum()
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (x, *arr[:2])))
    bn = BatchNorm(6)
    with torch.no_grad():
        for dst, a in zip((bn.scale, bn.offset, bn.mean, bn.var), arr):
            dst.copy_(torch.from_numpy(a))
    tx = torch.from_numpy(x).requires_grad_(True)
    (batch_norm(tx, torch.from_numpy(mask), bn, training=True)
     * torch.from_numpy(cot)).sum().backward()
    for got, w in zip((tx.grad, bn.scale.grad, bn.offset.grad), want):
        assert _rel(got, w) < GRAD_TOL
    assert not tx.grad[~torch.from_numpy(mask)].any()
    # the running statistics moved once, outside autograd
    assert not bn.mean.requires_grad
    assert not np.allclose(bn.mean.numpy(), arr[2])


def test_spline_conv_gradient_matches_jax():
    rng = np.random.RandomState(9)
    n, k, cin, cout = 150, 7, 5, 4
    x = rng.randn(n, cin).astype(np.float32)
    nbr = rng.randint(0, n, (n, k)).astype(np.int32)
    nmask = rng.rand(n, k) > 0.3
    attr = rng.rand(n, k, 2).astype(np.float32)
    node_mask = rng.rand(n) > 0.1
    w = (rng.randn(25, cin, cout) * 0.3).astype(np.float32)
    root = (rng.randn(cin, cout) * 0.3).astype(np.float32)
    cot = rng.randn(n, cout).astype(np.float32)

    def f(x, w, root):
        out = jax_spline_conv(x, jnp.asarray(nbr), jnp.asarray(nmask),
                              jnp.asarray(attr),
                              SplineConvParams(w, root, None), kernel_size=5,
                              node_mask=jnp.asarray(node_mask))
        return (out * cot).sum()
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (x, w, root)))
    conv = SplineConv(cin, cout, 5)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w))
        conv.root.copy_(torch.from_numpy(root))
    tx = torch.from_numpy(x).requires_grad_(True)
    out = spline_conv(tx, torch.from_numpy(nbr), torch.from_numpy(nmask),
                      torch.from_numpy(attr), conv, kernel_size=5,
                      node_mask=torch.from_numpy(node_mask))
    (out * torch.from_numpy(cot)).sum().backward()
    for got, w_ in zip((tx.grad, conv.weight.grad, conv.root.grad), want):
        assert _rel(got, w_) < GRAD_TOL


@pytest.mark.parametrize("aggr", ["max", "mean"])
def test_pool_graph_gradient_with_ties_matches_jax(aggr):
    """Features after a ReLU and rounded to quarters, so many nodes of a
    cell tie for its maximum (zeros above all): JAX's ``.at[].max`` and
    torch's ``scatter_reduce_("amax")`` both share the cotangent evenly
    among the tied entries; no NaN from the empty cells' ``-inf``."""
    rng = np.random.RandomState(10)
    n, k, grid = 2000, 6, (12, 9)
    pos = np.concatenate([rng.randint(0, 96, (n, 1)) / np.float32(96),
                          rng.randint(0, 72, (n, 1)) / np.float32(72),
                          rng.rand(n, 1)], 1).astype(np.float32)
    batch = np.repeat(np.arange(2), n // 2).astype(np.int32)
    nbr = np.clip(np.arange(n)[:, None] - rng.randint(0, 40, (n, k)), 0,
                  n - 1).astype(np.int32)
    nbr_mask = rng.rand(n, k) > 0.3
    node_mask = rng.rand(n) > 0.1
    x = np.maximum(np.round(rng.randn(n, 8) * 4) / 4, 0).astype(np.float32)
    cot = rng.randn(2 * grid[0] * grid[1], 8).astype(np.float32)
    kw = dict(grid=grid, batch_size=2, width=96, height=72, aggr=aggr)
    args = (pos, nbr, nbr_mask, node_mask, batch)

    def f(x):
        return (jax_pool(x, *map(jnp.asarray, args), **kw).x * cot).sum()
    want = jax.jit(jax.grad(f))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    pooled = pool_graph(tx, *map(torch.from_numpy, args), **kw)
    (pooled.x * torch.from_numpy(cot)).sum().backward()
    assert torch.isfinite(tx.grad).all()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    if aggr == "max":
        # ties occur, and a tied maximum's cotangent is split
        g = tx.grad.numpy()
        assert ((g != 0) & (np.abs(g) < np.abs(cot).max() / 2)).any()


def test_max_pool_margin_finds_the_nearest_runner_up():
    """Cell 0 holds 1.0, 1.0 (an exact tie, no gap), 0.75 and 1 - 2^-20;
    cell 1 holds 2.0 and 1.0; cell 2 one entry; cell 3 only negatives."""
    x = torch.tensor([1.0, 1.0, 0.75, 1 - 2 ** -20, 2.0, 1.0, 5.0, -1.0,
                      -2.0])[:, None]
    cols = torch.tensor([0, 0, 0, 0, 1, 1, 2, 3, 3])
    pos = torch.stack([(cols + 0.5) / 4, torch.full((9,), 0.5),
                       torch.zeros(9)], 1)
    kw = dict(grid=(4, 1), batch_size=1)
    ones = torch.ones(9, dtype=torch.bool)
    zeros = torch.zeros(9, dtype=torch.int32)
    assert max_pool_margin(x, pos, ones, zeros, **kw) == 2 ** -20
    # without the near runner-up: cell 0's 0.75 below 1 (cell 1's is half)
    keep = torch.arange(9) != 3
    assert max_pool_margin(x, pos, keep, zeros, **kw) == 0.25
