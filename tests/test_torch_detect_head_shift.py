"""The GNN head's K3 route (``models/yolox_head.gnn_head_scale_shift``) on
the CPU, where ``shift_spline_conv`` runs its plain version, at the
``dagr_s50`` head geometry (360x240, grids 14x10 and 7x5) at batch 1 (the
stream) and 6 (the batch detector): against the plain spline-conv head in
bf16 and in f32, the one reg + obj launch against the two convs, the
route's choice (``models/backbone.frozen_route``), the plain cases bit for
bit against the formulation before the route, and the kept packs.  The
CUDA launches are held against the plain head on the card by
``chip_smoke.py``."""
import pytest
import torch

from eventad_tpu_torch.config import Config
from eventad_tpu_torch.models import yolox_head as yh
from eventad_tpu_torch.models.backbone import (frozen_route,
                                                make_backbone_config)
from eventad_tpu_torch.models.graph import Graph, neighbor_rows
from eventad_tpu_torch.ops.norm import batch_norm
from eventad_tpu_torch.ops.spline_basis import ACTS
from eventad_tpu_torch.ops.spline_conv import cartesian_attr, spline_conv
from eventad_tpu_torch.ops.spline_shift import (prepare_shift,
                                                shift_spline_conv_plain)

import _torch_threads  # noqa: F401  (one intra-op thread)

BF16_TOL = 2e-2     # of each map's scale: bf16 roundings at other points
WIDTH = 64          # the head's channels at dagr-S (its levels 3 and 4)


def _geometry(batch: int, dtype: str = "bfloat16", **kw):
    return make_backbone_config(Config(batch_size=batch,
                                       compute_dtype=dtype))._replace(**kw)


def _pooled_graph(gen, bc, scale: int, dt) -> tuple:
    """A pooled level's output graph on grid ``bc.grids[2 + scale]``:
    three quarters of the cells active, positions pixel-rounded inside
    their cells (as the pooling rounds them), the 25 slots in
    ``neighbor_rows`` order with a fifth of the edges dropped, rows of
    post-ReLU features.  Returns ``(graph, attr, grid, cart_max)``."""
    grid = bc.grids[2 + scale]
    nx, ny = grid
    cells = nx * ny
    m = bc.batch_size * cells
    ar = torch.arange(m)
    cx, cy, cb = ar % nx, (ar // nx) % ny, ar // cells
    active = torch.rand(m, generator=gen) > 0.25
    px = torch.floor(((cx + torch.rand(m, generator=gen)) / nx + 1e-5)
                     * bc.width) / bc.width
    py = torch.floor(((cy + torch.rand(m, generator=gen)) / ny + 1e-5)
                     * bc.height) / bc.height
    pos = torch.stack([px, py, torch.rand(m, generator=gen)], 1)
    side = 5
    off = torch.arange(side * side)
    nxs = cx[:, None] + off % side - 2
    nys = cy[:, None] + off // side - 2
    in_fov = (nxs >= 0) & (nxs < nx) & (nys >= 0) & (nys < ny)
    nbr = cb[:, None] * cells + nys.clamp(0, ny - 1) * nx \
        + nxs.clamp(0, nx - 1)
    mask = in_fov & active[:, None] & active[nbr] \
        & (torch.rand(m, side * side, generator=gen) > 0.2)
    nbr = torch.where(mask, nbr, 0).to(torch.int32)
    x = torch.relu(torch.randn(m, WIDTH, generator=gen)) * active[:, None]
    g = Graph(x.to(dt), pos, nbr, mask, active,
              cb.to(torch.int32))
    cart_max = bc.cart_max[3 + scale]
    return g, cartesian_attr(pos, nbr, mask, cart_max, clamp=True), grid, \
        cart_max


def _head(seed: int = 0) -> yh.ScaleHead:
    """A scale head with random weights, biases and BN statistics."""
    gen = torch.Generator().manual_seed(seed)
    head = yh.ScaleHead(WIDTH, WIDTH, 2, 5, gen)
    with torch.no_grad():
        for blk in (head.stem, head.cls_conv, head.reg_conv):
            n = blk.bn.mean.shape[0]
            blk.bn.mean.copy_(0.3 * torch.randn(n, generator=gen))
            blk.bn.var.copy_(0.5 + torch.rand(n, generator=gen))
            blk.bn.scale.copy_(1 + 0.3 * torch.randn(n, generator=gen))
            blk.bn.offset.copy_(0.2 * torch.randn(n, generator=gen))
        for conv in (head.cls_pred, head.reg_pred, head.obj_pred):
            conv.bias.copy_(0.5 * torch.randn(conv.bias.shape,
                                              generator=gen))
    return head


def _parent_head(head, g, attr, grid, bc, training=False):
    """The head's formulation before the K3 route, verbatim: six plain
    spline convs, each block's BN, activation and mask in PyTorch ops."""
    def block(blk, gg):
        h = spline_conv(gg.x, gg.nbr, gg.nbr_mask, attr.to(gg.x.dtype),
                        blk.conv, kernel_size=bc.kernel_size, aggr=bc.aggr,
                        node_mask=gg.node_mask,
                        x_j=neighbor_rows(gg.x, grid, bc.batch_size, span=2))
        h = ACTS[bc.activation](batch_norm(h, gg.node_mask, blk.bn,
                                           training=training))
        zero = torch.zeros((), dtype=h.dtype, device=h.device)
        return gg._replace(x=torch.where(gg.node_mask[:, None], h, zero))

    def pred(conv, gg):
        out = spline_conv(gg.x, gg.nbr, gg.nbr_mask, attr.to(gg.x.dtype),
                          conv, kernel_size=bc.kernel_size, aggr=bc.aggr,
                          node_mask=gg.node_mask,
                          x_j=neighbor_rows(gg.x, grid, bc.batch_size,
                                            span=2))
        nx, ny = grid
        zero = torch.zeros((), dtype=out.dtype, device=out.device)
        xm = torch.where(g.node_mask[:, None], out, zero)
        return xm.reshape(bc.batch_size, ny, nx, -1).permute(0, 3, 1, 2)
    g1 = block(head.stem, g)
    gc, gr = block(head.cls_conv, g1), block(head.reg_conv, g1)
    return pred(head.cls_pred, gc), pred(head.reg_pred, gr), \
        pred(head.obj_pred, gr)


def _gap(got, want) -> float:
    """Widest gap of three maps, each over its scale (at least 1)."""
    return max(((a.float() - b.float()).abs().max()
                / b.float().abs().max().clamp(min=1.0)).item()
               for a, b in zip(got, want))


@pytest.mark.parametrize("batch,scale", [(1, 0), (1, 1), (6, 0), (6, 1)])
def test_route_matches_the_plain_head(batch, scale):
    """bf16 through the route against the plain head in bf16 and in f32
    (same weights, same graph); the route rounds at fewer points, so it
    lies at least as close to f32 as the plain bf16 head."""
    bc = _geometry(batch)
    gen = torch.Generator().manual_seed(100 * batch + scale)
    g, attr, grid, cart_max = _pooled_graph(gen, bc, scale, torch.bfloat16)
    head = _head(scale)
    with torch.no_grad():
        got = yh.gnn_head_scale_shift(head, g, attr, grid, bc,
                                      cart_max=cart_max)
        plain = _parent_head(head, g, attr, grid, bc)
        f32 = _parent_head(head, g._replace(x=g.x.float()), attr, grid,
                           _geometry(batch, "float32"))
    nx, ny = grid
    assert [tuple(m.shape) for m in got] == [
        (batch, c, ny, nx) for c in (2, 4, 1)]
    assert all(m.dtype == torch.bfloat16 for m in got)
    for m in got:   # masked cells read 0, as the plain head's
        rows = m.permute(0, 2, 3, 1).reshape(-1, m.shape[1])
        assert not rows[~g.node_mask].any()
    to_plain, to_f32 = _gap(got, plain), _gap(got, f32)
    assert to_plain < BF16_TOL, to_plain
    assert to_f32 < BF16_TOL, to_f32
    assert to_f32 <= _gap(plain, f32), (to_f32, _gap(plain, f32))


@pytest.mark.parametrize("batch", [1, 6])
def test_one_reg_obj_launch_equals_two_convs(batch):
    """``reg_pred`` and ``obj_pred`` as one conv of 5 outputs: its columns
    equal the two convs run apart on the same rows."""
    bc = _geometry(batch)
    g, attr, grid, cart_max = _pooled_graph(
        torch.Generator().manual_seed(7), bc, 0, torch.bfloat16)
    head = _head(1)
    u = torch.clamp(attr, 0.0, 1.0) * (bc.kernel_size - 1)
    prep = prepare_shift(u, g.nbr_mask, g.node_mask, grid=grid, span=2,
                         cart_max=cart_max, width=bc.width,
                         height=bc.height, kernel_size=bc.kernel_size)
    *_, (w, r, a, b, pack) = yh.head_shift_operands(head, torch.bfloat16,
                                                    prep.tap_idx)
    assert w.shape == (25, WIDTH, 5) and pack.o == 5
    both = shift_spline_conv_plain(g.x, prep, w, r, a, b, act=None)
    bf = torch.bfloat16
    for conv, cols in ((head.reg_pred, slice(0, 4)),
                       (head.obj_pred, slice(4, 5))):
        apart = shift_spline_conv_plain(
            g.x, prep, conv.weight.to(bf), conv.root.to(bf),
            torch.ones_like(conv.bias), conv.bias.to(bf).float(), act=None)
        assert torch.equal(both[:, cols], apart)


@pytest.mark.parametrize("case", ["bf16_cpu", "f32", "training",
                                  "fused_shift_off"])
def test_plain_cases_unchanged(case, monkeypatch):
    """The route does not take K3 for f32, training and ``fused_shift``
    off even on the card, and on the CPU never; each such case gives the
    formulation before the route bit for bit (training: the running
    statistics too) and launches nothing through ``shift_spline_conv``."""
    batch = 6 if case == "training" else 1
    dtype = "float32" if case == "f32" else "bfloat16"
    bc = _geometry(batch, dtype, fused_shift=case != "fused_shift_off")
    training = case == "training"
    dt = torch.float32 if case == "f32" else torch.bfloat16
    g, attr, grid, cart_max = _pooled_graph(
        torch.Generator().manual_seed(11), bc, 0, dt)
    on_card = frozen_route(bc, dt, torch.device("cuda"), training).pooled
    assert (on_card == "K3") == (case == "bf16_cpu")
    assert frozen_route(bc, dt, g.x.device, training).pooled != "K3"

    def refuse(*a, **kw):
        raise AssertionError("the K3 route was taken")
    monkeypatch.setattr(yh, "shift_spline_conv", refuse)
    head, twin = _head(2), _head(2)
    with torch.set_grad_enabled(training):
        got = yh.gnn_head_scale_forward(head, g, attr, grid, bc, training,
                                        cart_max=cart_max)
        want = _parent_head(twin, g, attr, grid, bc, training)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    for a, b in zip(head.buffers(), twin.buffers()):
        assert torch.equal(a, b)


def test_forward_takes_the_route_where_the_gate_opens(monkeypatch):
    """Where the route takes K3 (the card's case, the route asked for a
    CUDA device here on the CPU) the forward is the K3 route: five
    launches a scale, the route's maps."""
    bc = _geometry(1)
    g, attr, grid, cart_max = _pooled_graph(
        torch.Generator().manual_seed(5), bc, 1, torch.bfloat16)
    head = _head(3)
    with torch.no_grad():
        want = yh.gnn_head_scale_shift(head, g, attr, grid, bc,
                                       cart_max=cart_max)
    calls = []

    def counted(*a, **kw):
        calls.append(kw["act"])
        return shift_spline_conv_plain(*a, **kw)
    monkeypatch.setattr(yh, "frozen_route", lambda b, dt, dev, t: (
        frozen_route(b, dt, torch.device("cuda"), t)))
    monkeypatch.setattr(yh, "shift_spline_conv", counted)
    with torch.no_grad():
        got = yh.gnn_head_scale_forward(head, g, attr, grid, bc,
                                        cart_max=cart_max)
    assert calls == ["relu"] * 3 + [None] * 2
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_packs_are_kept_until_an_in_place_update(monkeypatch):
    """A second read with unchanged weights casts, folds and packs nothing
    (the same objects); an in-place update of any conv weight, bias or BN
    statistic packs anew, and the maps follow it."""
    bc = _geometry(1)
    g, attr, grid, cart_max = _pooled_graph(
        torch.Generator().manual_seed(9), bc, 0, torch.bfloat16)
    head = _head(4)
    packed = []
    orig = yh.pack_shift_weights

    def counted(*a, **kw):
        packed.append(a[1].shape[-1])
        return orig(*a, **kw)
    monkeypatch.setattr(yh, "pack_shift_weights", counted)

    def read():
        with torch.no_grad():
            return yh.gnn_head_scale_shift(head, g, attr, grid, bc,
                                           cart_max=cart_max)
    first = read()
    assert packed == [WIDTH, WIDTH, WIDTH, 2, 5]
    kept = head.__dict__["head_shift_operands"][1]
    again = read()
    assert len(packed) == 5
    assert head.__dict__["head_shift_operands"][1] is kept
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    for change in (lambda: head.obj_pred.weight.mul_(2),
                   lambda: head.reg_conv.bn.var.add_(1.0),
                   lambda: head.cls_pred.bias.sub_(1.0)):
        before = read()
        with torch.no_grad():
            change()
        n = len(packed)
        after = read()
        assert len(packed) == n + 5
        assert not all(torch.equal(a, b) for a, b in zip(before, after))
