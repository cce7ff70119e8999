"""Graph pooling's dispatch and K8's wrapper (``ops/pooling``) on the CPU:
``pool_graph`` keeps the plain formulation there, wherever a gradient
flows into ``x`` and under deterministic algorithms; ``pool_graph_cuda``
refuses what its kernel does not take with ``ValueError``; a numpy mirror
of the kernel's two passes equals the plain formulation; every pooling
call of the scoring forward passes the kernel's layout check; K8's
launches are a counter of the program's spans.  The kernel itself is
held against the plain formulation on the card by ``chip_smoke.py``."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from eventad_tpu_torch.config import Config
from eventad_tpu_torch.data.synthetic import make_synthetic_batch
from eventad_tpu_torch.models import backbone as bb
from eventad_tpu_torch.models.dagr import (graph_static_config, init_model,
                                           model_forward)
from eventad_tpu_torch.models.graph import Graph
from eventad_tpu_torch.ops import pooling
from eventad_tpu_torch.utils import spans

import _torch_threads  # noqa: F401  (one intra-op thread)

KW = dict(grid=(12, 9), batch_size=2, width=96, height=72)


def _inputs(seed=0, n=600, k=6, c=8):
    rng = np.random.RandomState(seed)
    pos = np.concatenate([rng.randint(0, 96, (n, 1)) / np.float32(96),
                          rng.randint(0, 72, (n, 1)) / np.float32(72),
                          rng.rand(n, 1)], 1).astype(np.float32)
    nbr = np.clip(np.arange(n)[:, None] - rng.randint(0, 40, (n, k)), 0,
                  n - 1).astype(np.int32)
    return dict(
        x=torch.from_numpy(rng.randn(n, c).astype(np.float32)),
        pos=torch.from_numpy(pos), nbr=torch.from_numpy(nbr),
        nbr_mask=torch.from_numpy(rng.rand(n, k) > 0.3),
        node_mask=torch.from_numpy(rng.rand(n) > 0.1),
        batch=torch.from_numpy(np.repeat(np.arange(2), n // 2)
                               .astype(np.int32)),
        pos_src=torch.from_numpy(pos[nbr][..., :2]))


def _call(fn, inp, **kw):
    a = {k: v for k, v in inp.items() if k != "pos_src"}
    return fn(*a.values(), **dict(KW, pos_src=inp["pos_src"], **kw))


@pytest.mark.parametrize("aggr,temporal", [("max", False), ("mean", True)])
def test_cpu_takes_the_plain_formulation(aggr, temporal):
    inp = _inputs()
    before = pooling.pool_graph_cuda.launches
    kw = dict(aggr=aggr, keep_temporal_ordering=temporal,
              return_pos_nbr=True)
    got, got_pn = _call(pooling.pool_graph, inp, **kw)
    want, want_pn = _call(pooling.pool_graph_plain, inp, **kw)
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)
    assert torch.equal(got_pn, want_pn)
    assert int(want.nbr_mask.sum()) > 50
    assert pooling.pool_graph_cuda.launches == before


def test_gradient_takes_the_autograd_formulation():
    inp = _inputs()
    x = inp["x"].clone().requires_grad_(True)
    assert pooling.needs_plain(x)
    with torch.no_grad():
        assert not pooling.needs_plain(x)
    assert not pooling.needs_plain(inp["x"])
    g = _call(pooling.pool_graph, dict(inp, x=x))
    g.x.sum().backward()
    # max pooling routes each cell's gradient to one entry per channel
    assert x.grad is not None
    assert int((x.grad != 0).sum()) == int((g.x != 0).sum())


# csrc/pool_graph.cu's constants: 0.9999999 and 1e-5 rounded to f32
_CLAMP_HI = np.uint32(0x3f7ffffe).view(np.float32)
_EPS = np.uint32(0x3727c5ac).view(np.float32)


def _cell_of(p, n):
    c = np.minimum(np.maximum(np.float32(p), np.float32(0)), _CLAMP_HI)
    return int(np.floor(np.float32(c * np.float32(n))))


def _enc(v):
    u = int(np.float32(v).view(np.uint32))
    return (~u & 0xffffffff) if u & 0x80000000 else u | 0x80000000


def _dec(e):
    u = (e & 0x7fffffff) if e & 0x80000000 else ~e & 0xffffffff
    return np.uint32(u).view(np.float32)


def _pixel_mean(total, cnt, size):
    mean = np.float32(np.float32(total) / np.float32(cnt))
    fl = np.floor(np.float32(np.float32(mean + _EPS) * np.float32(size)))
    return np.float32(fl * np.float32(np.float32(1) / np.float32(size)))


def _mirror(x, pos, nbr, nbr_mask, node_mask, batch, *, grid, batch_size,
            width, height, aggr="max", span=2, keep_temporal_ordering=False,
            pos_src=None, return_pos_nbr=False):
    """numpy mirror of ``csrc/pool_graph.cu``, step for step: the node pass
    (a node's cell, its edges' offset bits, its position, count and
    channels into the cell's record, maxima order-encoded with 0 empty) in
    node order, then the cell pass (features, pooled position, the slots'
    masks, indices and neighbour positions from the records)."""
    xf, pos = x.float().numpy(), pos.numpy()
    nbr, nm, vm, bt = (t.numpy() for t in (nbr, nbr_mask, node_mask, batch))
    ps = None if pos_src is None else pos_src.numpy()
    nx, ny = grid
    m, (n, c), side = batch_size * nx * ny, xf.shape, 2 * span + 1
    sums = np.zeros((m, 3), np.float32)
    cnt, bits, tmax = (np.zeros(m, np.int64) for _ in range(3))
    feat = np.zeros((m, c), np.float32 if aggr == "mean" else np.int64)
    for i in np.flatnonzero(vm):
        b, ix, iy = bt[i], _cell_of(pos[i, 0], nx), _cell_of(pos[i, 1], ny)
        for s in np.flatnonzero(nm[i]):
            if ps is not None:
                src = ps[i, s]
            else:
                j = nbr[i, s]
                if not (0 <= j < n and vm[j] and bt[j] == b):
                    continue
                src = pos[j]
            rx, ry = _cell_of(src[0], nx) - ix, _cell_of(src[1], ny) - iy
            if (rx or ry) and abs(rx) <= span and abs(ry) <= span:
                bits[(b * ny + iy) * nx + ix] |= 1 << ((ry + span) * side
                                                      + rx + span)
        cell = (b * ny + iy) * nx + ix
        sums[cell] += pos[i]
        cnt[cell] += 1
        if keep_temporal_ordering:
            tmax[cell] = max(tmax[cell], _enc(pos[i, 2]))
        for ch in range(c):
            if aggr == "mean":
                feat[cell, ch] += xf[i, ch]
            else:
                feat[cell, ch] = max(feat[cell, ch], _enc(xf[i, ch]))
    slots = side * side
    out_x = np.zeros((m, c), np.float32)
    out_pos = np.zeros((m, 3), np.float32)
    out_nbr = np.zeros((m, slots), np.int32)
    out_mask = np.zeros((m, slots), bool)
    out_pn = np.zeros((m, slots, 2), np.float32)
    for cell in range(m):
        cn = np.float32(max(cnt[cell], 1))
        for ch in range(c):
            if aggr == "mean":
                v = np.float32(feat[cell, ch] / cn)
            else:
                v = _dec(feat[cell, ch]) if feat[cell, ch] else 0.0
                v = v if np.isfinite(v) else 0.0
            out_x[cell, ch] = v if cnt[cell] else 0.0
        out_pos[cell] = (_pixel_mean(sums[cell, 0], cn, width),
                         _pixel_mean(sums[cell, 1], cn, height),
                         np.float32(sums[cell, 2] / cn))
        cx, cy, cb = cell % nx, cell // nx % ny, cell // (nx * ny)
        for s in range(slots):
            sx, sy = cx + s % side - span, cy + s // side - span
            fov = 0 <= sx < nx and 0 <= sy < ny
            nc = (cb * ny + min(max(sy, 0), ny - 1)) * nx \
                + min(max(sx, 0), nx - 1)
            on = bool(cnt[cell] and fov and bits[cell] >> s & 1
                      and cnt[nc])
            if on and keep_temporal_ordering:
                on = _dec(tmax[cell]) > _dec(tmax[nc])
            out_mask[cell, s], out_nbr[cell, s] = on, nc if on else 0
            if fov:
                ncn = np.float32(max(cnt[nc], 1))
                out_pn[cell, s] = (_pixel_mean(sums[nc, 0], ncn, width),
                                   _pixel_mean(sums[nc, 1], ncn, height))
    g = Graph(torch.from_numpy(out_x).to(x.dtype), torch.from_numpy(out_pos),
              torch.from_numpy(out_nbr), torch.from_numpy(out_mask),
              torch.from_numpy(cnt > 0),
              torch.arange(m, dtype=torch.int32) // (nx * ny))
    return (g, torch.from_numpy(out_pn)) if return_pos_nbr else g


@pytest.mark.parametrize("aggr,temporal,with_pos_src,dtype", [
    ("max", False, True, torch.float32),
    ("mean", True, False, torch.bfloat16),
    ("max", True, False, torch.bfloat16),
    ("mean", False, True, torch.float32)])
def test_kernel_mirror_matches_the_plain_formulation(aggr, temporal,
                                                     with_pos_src, dtype):
    """The kernel's algorithm against the plain formulation on the CPU:
    equal, but the pooled ``x``, ``y`` and ``pos_nbr``, which the kernel
    rounds as PyTorch divides by a scalar on the card (times the f32
    reciprocal), within one unit in the last place."""
    inp = _inputs(seed=3, n=400)
    inp["x"] = inp["x"].to(dtype)
    inp["x"][5, 3], inp["x"][7, 2] = float("inf"), float("-inf")
    inp["pos"][::37, 0], inp["pos"][::41, 1] = 1.0, -0.1
    if not with_pos_src:
        inp["pos_src"] = None
    kw = dict(aggr=aggr, keep_temporal_ordering=temporal,
              return_pos_nbr=True)
    (got, got_pn), (want, want_pn) = (_call(fn, inp, **kw) for fn in (
        _mirror, pooling.pool_graph_plain))
    for f in ("x", "nbr", "nbr_mask", "node_mask", "batch"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert torch.equal(got.pos[:, 2], want.pos[:, 2])
    for a, b in ((got.pos[:, :2], want.pos[:, :2]), (got_pn, want_pn)):
        np.testing.assert_array_max_ulp(a.numpy(), b.numpy(), maxulp=1)
    assert int(want.nbr_mask.sum()) > 20


def test_deterministic_algorithms_take_the_plain_formulation():
    x = _inputs()["x"]
    assert not pooling.needs_plain(x)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        assert pooling.needs_plain(x)
    finally:
        torch.use_deterministic_algorithms(False)
    assert not pooling.needs_plain(x)


def _bad(name):
    """The inputs with one thing the kernel does not take."""
    inp = _inputs()
    if name == "cpu":
        return inp, "CUDA"
    if name == "x_dtype":
        inp["x"] = inp["x"].to(torch.float64)
        return inp, "float32 or bfloat16"
    if name == "pos_dtype":
        inp["pos"] = inp["pos"].to(torch.float64)
        return inp, "pos: expected torch.float32"
    if name == "nbr_dtype":
        inp["nbr"] = inp["nbr"].long()
        return inp, "nbr: expected torch.int32"
    if name == "x_strided":
        inp["x"] = inp["x"].t().contiguous().t()
        return inp, "x: expected a contiguous tensor"
    if name == "batch_strided":
        inp["batch"] = torch.stack([inp["batch"]] * 2, 1)[:, 0]
        return inp, "batch: expected a contiguous tensor"
    if name == "nbr_column_strided":
        inp["nbr"] = inp["nbr"].t().contiguous().t()
        return inp, "nbr: expected a unit stride"
    if name == "pos_src_shape":
        inp["pos_src"] = inp["pos_src"][:, :3]
        return inp, "pos_src: expected shape"
    raise KeyError(name)


@pytest.mark.parametrize("name", ["cpu", "x_dtype", "pos_dtype",
                                  "nbr_dtype", "x_strided", "batch_strided",
                                  "nbr_column_strided", "pos_src_shape"])
def test_kernel_wrapper_refuses(name):
    inp, match = _bad(name)
    with pytest.raises(ValueError, match=match):
        _call(pooling.pool_graph_cuda, inp)


def test_kernel_wrapper_refuses_a_wide_span():
    with pytest.raises(ValueError, match="span"):
        _call(pooling.pool_graph_cuda, _inputs(), span=3)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_forward_pooling_calls_fit_the_kernel(dtype):
    """The scoring forward's four poolings pass K8's layout check (the
    level-1 edge tables are column slices, the pooled levels' ``pos_src``
    a slice of the neighbour rows)."""
    cfg = Config(batch_size=2, width=96, height=72, scale=1, use_image=False,
                 event_buckets=(512,), graph_lookback=256,
                 compute_dtype=dtype)
    model, bc, mc = init_model(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    calls, orig = [], bb.pool_graph

    def rec(*a, **kw):
        calls.append((a, kw))
        return orig(*a, **kw)
    bb.pool_graph = rec
    try:
        with torch.no_grad():
            model_forward(model, make_synthetic_batch(cfg, seed=1), bc, mc,
                          graph_static_config(cfg))
    finally:
        bb.pool_graph = orig
    assert [kw["aggr"] for _, kw in calls] == ["max", "max", "max", "mean"]
    for a, kw in calls:
        n, c, k, m = pooling.pool_layout(
            *a, grid=kw["grid"], batch_size=kw["batch_size"],
            aggr=kw["aggr"], span=kw["span"], pos_src=kw["pos_src"])
        assert m == bc.batch_size * kw["grid"][0] * kw["grid"][1]
        assert a[0].dtype == getattr(torch, dtype)


def test_k8_launches_are_a_span_counter():
    spans.reset()
    assert spans.KERNELS["K8"] == ("eventad_tpu_torch.ops.pooling",
                                   "pool_graph_cuda")
    assert "launches/K8" in spans._counter_snapshot()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with spans.span("model/forward"):
                pooling.pool_graph_cuda.launches += 8
        assert spans.summary()["counters"]["launches/K8"] == 8
    finally:
        pooling.pool_graph_cuda.launches -= 8
        spans.reset()
