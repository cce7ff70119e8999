"""The plain reference of the scoring forward: EventAD's frozen DAGR
feature path (level-0 event graph, ResNet-50 pyramid, the five-level
spline-conv GNN with voxel pooling) and its recurrent anomaly head, in
float32 plain PyTorch, read straight from a reference-format state dict
(the upstream checkpoint's keys: the DAGR under ``dagr_model.``, the head's
keys flat).

Written from the semantics of the program's plain (CPU, f32) route, with
no kernel, cache, pack or table of the program.  ``q`` rounds what enters
a product (images, activations, weights); the identity gives the f32
reference, :func:`fp8` the control that computes in 8-bit floats.
On the card call :func:`strict_f32` first: TF32 would round the f32
products to 10 bits."""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .geometry import LAYER_SPECS, Geometry

DAGR = "dagr_model."
_LAYER_NAMES = ("conv_block1", "layer2", "layer3", "layer4", "layer5")
_BIG = torch.iinfo(torch.int64).max
Q = Callable[[torch.Tensor], torch.Tensor]


def f32(x: torch.Tensor) -> torch.Tensor:
    return x


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude at the format's largest value, 448), back in f32."""
    amax = x.detach().abs().max().to(torch.float32)
    s = torch.where(amax > 0, amax / 448.0, torch.ones_like(amax))
    return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def strict_f32() -> None:
    """f32 products on the card in f32, not TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Graph(NamedTuple):
    x: torch.Tensor
    pos: torch.Tensor
    nbr: torch.Tensor
    nbr_mask: torch.Tensor
    node_mask: torch.Tensor
    batch: torch.Tensor
    off: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# level-0 event graph (reference ev_graph.cu:15-80)
# ---------------------------------------------------------------------------
def spiral_index(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Visit order of offset (dx, dy) in the reference's square spiral."""
    u = dx + dy
    s = dy - dx
    r = (u.abs() + s.abs()) >> 1
    v = s - 2 * r
    upper = (u > 0) | ((u == 0) & (s > 0))
    return 4 * r * r + torch.where(upper, v, -v)


def neighbours(pos, valid, ranks, *, radius: int, delta_t_us: int,
               max_neighbors: int, max_queue_size: int, lookback: int,
               chunk: int = 256):
    """For every valid event the older events ``d = 1..lookback`` back
    within the Chebyshev radius, ``delta_t_us`` and the queue-rank cap,
    the ``K - 1`` smallest keys ``spiral * Q + rank`` (the nearer first at
    equal key); slot 0 the self edge.  ``pos [B, N, 3]``; returns ``nbr
    [B, N, K]``, ``mask`` and ``doff [B, N, K, 2]`` (dst - src)."""
    b, n, _ = pos.shape
    dev = pos.device
    lookback = min(lookback, n)
    ranks = torch.where(valid, ranks.to(torch.int32), n + 1)
    x, y, t = (pos[..., i].to(torch.int64) for i in range(3))
    d = torch.arange(1, lookback + 1, device=dev)
    nbrs, masks, offs = [], [], []
    for i0 in range(0, n, chunk):
        ii = torch.arange(i0, min(i0 + chunk, n), device=dev)
        jj = ii[:, None] - d[None, :]
        jc = jj.clamp(min=0)
        dx = x[:, jc] - x[:, ii, None]
        dy = y[:, jc] - y[:, ii, None]
        dt = t[:, ii, None] - t[:, jc]
        rk = ranks[:, jc]
        ok = ((jj >= 0) & valid[:, jc] & valid[:, ii, None]
              & (dx.abs() <= radius) & (dy.abs() <= radius)
              & (dt <= delta_t_us) & (rk < max_queue_size))
        key = torch.where(ok, spiral_index(dx, dy) * max_queue_size + rk,
                          _BIG)
        top = torch.sort(key, dim=-1, stable=True)
        sel = top.indices[..., :max_neighbors - 1]
        found = top.values[..., :max_neighbors - 1] < _BIG
        nbrs.append(torch.where(found, ii[:, None] - (sel + 1), 0))
        masks.append(found)
        offs.append(torch.where(found[..., None], -torch.stack(
            [dx.gather(-1, sel), dy.gather(-1, sel)], -1), 0))
    self_idx = torch.arange(n, device=dev).expand(b, n)[..., None]
    nbr = torch.cat([self_idx, torch.cat(nbrs, 1)], -1)
    mask = torch.cat([valid[..., None], torch.cat(masks, 1)], -1)
    doff = torch.cat([torch.zeros(b, n, 1, 2, dtype=torch.int64,
                                  device=dev), torch.cat(offs, 1)], 2)
    return (torch.where(mask, nbr, 0).to(torch.int32), mask,
            doff.to(torch.int32))


def level0_graph(batch: dict, geo: Geometry) -> Graph:
    """The flattened ``B * N`` level-0 graph of a batch."""
    pos, valid = batch["pos"], batch["valid"]
    b, n, _ = pos.shape
    dev = pos.device
    nbr, nbrm, doff = neighbours(
        pos, valid, batch["rank"], radius=geo.radius_px,
        delta_t_us=geo.delta_t_us, max_neighbors=geo.max_neighbors,
        max_queue_size=geo.max_queue_size, lookback=geo.graph_lookback)
    off = (torch.arange(b, dtype=torch.int32, device=dev) * n)[:, None, None]
    denom = torch.tensor((geo.model_width, geo.model_height,
                          geo.time_window_us), dtype=torch.float32,
                         device=dev)
    vm = valid.reshape(b * n)
    return Graph(
        torch.where(vm[:, None], batch["polarity"].reshape(b * n, 1), 0.0),
        (pos.to(torch.float32) / denom).reshape(b * n, 3),
        (nbr + off).reshape(b * n, -1), nbrm.reshape(b * n, -1), vm,
        torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(n),
        doff.reshape(b * n, -1, 2))


# ---------------------------------------------------------------------------
# ResNet pyramid (torchvision ResNet + the 1x1 feature remaps)
# ---------------------------------------------------------------------------
def _bn(sd, key: str) -> tuple:
    """(scale, offset, mean, var) of a BN under ``key`` (torch_geometric
    nests a BatchNorm1d at ``.module``)."""
    k = key if f"{key}.weight" in sd else f"{key}.module"
    return (sd[f"{k}.weight"], sd[f"{k}.bias"], sd[f"{k}.running_mean"],
            sd[f"{k}.running_var"])


def _bn2d(x, p, eps: float = 1e-5):
    scale, offset, mean, var = p
    a = scale * torch.rsqrt(var + eps)
    return x * a[:, None, None] + (offset - mean * a)[:, None, None]


def cnn_features(sd, image: torch.Tensor, geo: Geometry, q: Q = f32):
    """``image [B, H, W, 3]`` in [0, 1] -> the five remapped maps, NHWC."""
    r = DAGR + "backbone.net.module."
    blocks, expansion = LAYER_SPECS[geo.img_net]

    def conv(x, key, stride=1):
        w = sd[key]
        return q(F.conv2d(q(x), q(w), stride=stride,
                          padding=(w.shape[2] - 1) // 2))
    x = image.permute(0, 3, 1, 2)
    h = conv(x, r + "conv1.weight", 2)
    taps = [h]
    h = q(torch.relu(_bn2d(h, _bn(sd, r + "bn1"))))
    h = F.max_pool2d(h, 3, 2, padding=1)
    for li, n in enumerate(blocks, start=1):
        for bi in range(n):
            base = f"{r}layer{li}.{bi}"
            stride = 2 if (li > 1 and bi == 0) else 1
            n_conv = 3 if expansion == 4 else 2
            y = h
            for ci in range(1, n_conv + 1):
                s = stride if ci == (2 if n_conv == 3 else 1) else 1
                y = q(_bn2d(conv(y, f"{base}.conv{ci}.weight", s),
                            _bn(sd, f"{base}.bn{ci}")))
                if ci < n_conv:
                    y = torch.relu(y)
            ident = h
            if f"{base}.downsample.0.weight" in sd:
                ident = q(_bn2d(conv(h, f"{base}.downsample.0.weight",
                                     stride), _bn(sd, f"{base}.downsample.1")))
            h = q(torch.relu(y + ident))
        taps.append(h)
    p = DAGR + "backbone.net.feature_dconv."
    return [q((F.conv2d(q(t), q(sd[f"{p}{i}.weight"]))
               + sd[f"{p}{i}.bias"][:, None, None]).permute(0, 2, 3, 1))
            for i, t in enumerate(taps)]


# ---------------------------------------------------------------------------
# image rows at node positions
# ---------------------------------------------------------------------------
def _interp(dst: int, src: int, dev) -> torch.Tensor:
    f = np.arange(dst) * (src - 1) / max(dst - 1, 1)
    i0 = np.floor(f).astype(np.int64)
    t = (f - i0).astype(np.float32)
    i1 = np.minimum(i0 + 1, src - 1)
    a = np.zeros((dst, src), np.float32)
    a[np.arange(dst), i0] += 1 - t
    a[np.arange(dst), i1] += t
    return torch.as_tensor(a, device=dev)


def upsampled_rows(feat, pos, batch, width: int, height: int):
    """The align-corners upsample of an NHWC map to ``width`` x ``height``,
    read at each node's pixel (round half to even, clipped)."""
    ay = _interp(height, feat.shape[1], feat.device)
    ax = _interp(width, feat.shape[2], feat.device)
    up = torch.einsum("Hh,bhWc->bHWc", ay,
                      torch.einsum("Ww,bhwc->bhWc", ax, feat))
    xi = torch.clamp(torch.round(pos[:, 0] * width).long(), 0, width - 1)
    yi = torch.clamp(torch.round(pos[:, 1] * height).long(), 0, height - 1)
    return up[batch.long(), yi, xi]


def bilinear_rows(feat, pos, batch, node_mask, width: int, height: int):
    """``grid_sample(align_corners=True)`` of ``feat [B, H', W', C]`` at
    the nodes, zero padding, zero outside ``node_mask``."""
    b, hp, wp, c = feat.shape
    fx = pos[:, 0] * width * (wp - 1) / max(width - 1, 1)
    fy = pos[:, 1] * height * (hp - 1) / max(height - 1, 1)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    tx, ty = (fx - x0)[:, None], (fy - y0)[:, None]
    x0i, y0i, bi = x0.long(), y0.long(), batch.long()

    def tap(yy, xx):
        ok = (yy >= 0) & (yy < hp) & (xx >= 0) & (xx < wp)
        v = feat[bi, yy.clamp(0, hp - 1), xx.clamp(0, wp - 1)]
        return torch.where(ok[:, None], v, 0.0)
    out = ((1 - ty) * ((1 - tx) * tap(y0i, x0i) + tx * tap(y0i, x0i + 1))
           + ty * ((1 - tx) * tap(y0i + 1, x0i)
                   + tx * tap(y0i + 1, x0i + 1)))
    return torch.where(node_mask[:, None], out, 0.0)


# ---------------------------------------------------------------------------
# spline convolution, BN, pooling
# ---------------------------------------------------------------------------
def _tap_ranges(ks: int, attr_range):
    if attr_range is None:
        return ((0, ks - 1), (0, ks - 1))
    out = []
    for lo, hi in attr_range:
        u_lo = min(max(float(lo), 0.0), 1.0) * (ks - 1)
        u_hi = min(max(float(hi), 0.0), 1.0) * (ks - 1)
        i0 = max(min(int(np.floor(u_lo - 1e-5)), ks - 2), 0)
        i1 = max(min(int(np.floor(u_hi + 1e-5)), ks - 2), 0)
        out.append((i0, min(i1 + 1, ks - 1)))
    return tuple(out)


def spline_conv(x, x_j, nbr_mask, attr, weight, root, *, ks: int,
                aggr: str, node_mask, attr_range=None, fold_center=False,
                q: Q = f32):
    """Degree-1 B-spline convolution of the gathered rows ``x_j [N, K,
    C]`` with pseudo-coordinates ``attr [N, K, 2]``, kernel ``weight [ks^2,
    C, O]`` and root ``root [C, O]``; ``fold_center``: the self edge was
    dropped and its centre-tap product joins the root."""
    n, k = nbr_mask.shape
    cin = x.shape[1]
    (mx0, mx1), (my0, my1) = _tap_ranges(ks, attr_range)
    nxs, nys = mx1 - mx0 + 1, my1 - my0 + 1
    u = torch.clamp(attr, 0.0, 1.0) * (ks - 1)

    def axis(ud, m0, nsub):
        i0 = torch.clamp(torch.floor(ud).to(torch.int32), 0, ks - 2)
        fr = ud - i0
        loc = (i0 - m0)[..., None]
        ar = torch.arange(nsub, device=ud.device)
        return ((loc == ar) * (1.0 - fr)[..., None]
                + (loc + 1 == ar) * fr[..., None])
    cx = axis(u[..., 0], mx0, nxs) * nbr_mask[..., None]
    cy = axis(u[..., 1], my0, nys)
    if aggr == "mean":
        deg = nbr_mask.sum(dim=1, keepdim=True).clamp(min=1)
        cx = cx / deg[..., None]
    coeff = (cy[..., :, None] * cx[..., None, :]).reshape(n, k, nxs * nys)
    z = q(torch.einsum("nkm,nkc->nmc", coeff, x_j))
    w = q(weight)
    sub = (np.arange(my0, my1 + 1)[:, None] * ks
           + np.arange(mx0, mx1 + 1)[None, :]).reshape(-1)
    w_sub = w[torch.as_tensor(sub, device=x.device)]
    out = z.reshape(n, -1) @ w_sub.reshape(-1, w.shape[-1])
    r = q(root)
    if fold_center:
        c = (ks - 1) // 2
        r = r + w[c + c * ks]
    out = out + x @ r
    return q(torch.where(node_mask[:, None], out, 0.0))


def batch_norm(x, mask, p, eps: float = 1e-5):
    scale, offset, mean, var = p
    y = (x - mean) * torch.reciprocal(torch.sqrt(var + eps))
    return torch.where(mask[:, None], y * scale + offset, 0.0)


def grid_rows(src, grid, batch_size: int, span: int = 2):
    """Slot ``s`` of cell ``(b, cy, cx)`` is cell ``(b, cy + oy, cx +
    ox)``; out of the grid zero.  ``src [M, C]`` -> ``[M, S, C]``."""
    nx, ny = grid
    side = 2 * span + 1
    c = src.shape[1]
    gp = F.pad(src.reshape(batch_size, ny, nx, c),
               (0, 0, span, span, span, span))
    slots = [gp[:, span + oy:span + oy + ny, span + ox:span + ox + nx]
             for oy in range(-span, span + 1)
             for ox in range(-span, span + 1)]
    return torch.stack(slots, dim=3).reshape(batch_size * ny * nx,
                                             side * side, c)


def pool(g: Graph, pos_src, *, grid, batch_size: int, width: int,
         height: int, aggr: str, keep_temporal_ordering: bool,
         span: int = 2) -> Graph:
    """Voxel pooling of ``g`` into the cell grid: cell positions the mean
    of their nodes snapped to the pixel, features the max (or mean), edges
    between cells within ``span`` that a level-below edge joins."""
    x, pos, nbr_mask, node_mask = g.x, g.pos, g.nbr_mask, g.node_mask
    nx, ny = grid
    ncells = nx * ny
    m_total = batch_size * ncells
    side = 2 * span + 1
    n_off = side * side
    dev = x.device
    pc = torch.clamp(pos, 0.0, 0.9999999)
    ix = torch.floor(pc[:, 0] * nx).long()
    iy = torch.floor(pc[:, 1] * ny).long()
    cell = g.batch.long() * ncells + iy * nx + ix
    cell_safe = torch.where(node_mask, cell, m_total)
    ps = torch.clamp(pos_src, 0.0, 0.9999999)
    rel_x = torch.floor(ps[..., 0] * nx).long() - ix[:, None]
    rel_y = torch.floor(ps[..., 1] * ny).long() - iy[:, None]
    e_ok = (nbr_mask & node_mask[:, None] & ((rel_x != 0) | (rel_y != 0))
            & (rel_x.abs() <= span) & (rel_y.abs() <= span))
    rel_idx = ((rel_y + span) * side + (rel_x + span)).clamp(0, n_off - 1)
    offs = torch.arange(n_off, device=dev)
    onehot = ((rel_idx[..., None] == offs) & e_ok[..., None]).any(1)

    def cell_sum(rows):
        acc = torch.zeros((m_total + 1, rows.shape[1]), device=dev)
        return acc.index_add_(0, cell_safe, rows.to(torch.float32))[:m_total]
    nm = node_mask[:, None]
    pcnt = cell_sum(nm.to(torch.float32))[:, 0]
    exist = cell_sum(onehot.to(torch.float32)) > 0
    pp = cell_sum(torch.where(nm, pos, 0.0)) / pcnt.clamp(min=1.0)[:, None]
    pooled_pos = torch.stack([
        torch.floor((pp[:, 0] + 1e-5) * width) / width,
        torch.floor((pp[:, 1] + 1e-5) * height) / height, pp[:, 2]], 1)
    active = pcnt > 0
    if aggr == "mean":
        pooled_x = (cell_sum(torch.where(nm, x, 0.0))
                    / pcnt.clamp(min=1.0)[:, None])
    else:
        c = x.shape[1]
        acc = torch.full((m_total + 1, c), -torch.inf, device=dev)
        acc.scatter_reduce_(0, cell_safe[:, None].expand(-1, c),
                            torch.where(nm, x, -torch.inf), "amax")
        pooled_x = acc[:m_total]
        pooled_x = torch.where(torch.isfinite(pooled_x), pooled_x, 0.0)
    cells = torch.arange(m_total, device=dev)
    cx, cy, cb = cells % nx, (cells // nx) % ny, cells // ncells
    nxs = cx[:, None] + (offs % side - span)[None, :]
    nys = cy[:, None] + (offs // side - span)[None, :]
    in_fov = (nxs >= 0) & (nxs < nx) & (nys >= 0) & (nys < ny)
    nbr_out = (cb[:, None] * ncells + nys.clamp(0, ny - 1) * nx
               + nxs.clamp(0, nx - 1))
    cols = [active[:, None].to(torch.float32)]
    if keep_temporal_ordering:
        tmax = torch.full((m_total + 1,), -torch.inf, device=dev)
        tmax.scatter_reduce_(0, cell_safe, torch.where(
            node_mask, pos[:, 2], -torch.inf), "amax")
        tmax = tmax[:m_total]
        cols.append(tmax[:, None])
    shifts = grid_rows(torch.cat(cols, 1), grid, batch_size, span)
    mask_out = exist & in_fov & active[:, None] & (shifts[..., 0] > 0)
    if keep_temporal_ordering:
        mask_out = mask_out & (tmax[:, None] > shifts[..., 1])
    return Graph(torch.where(active[:, None], pooled_x, 0.0), pooled_pos,
                 torch.where(mask_out, nbr_out, 0).to(torch.int32),
                 mask_out, active, cb.to(torch.int32))


# ---------------------------------------------------------------------------
# the GNN pyramid
# ---------------------------------------------------------------------------
def _layer_params(sd, li: int):
    base = f"{DAGR}backbone.{_LAYER_NAMES[li]}"
    blocks = []
    for bi in (1, 2):
        cb = f"{base}.conv_block{bi}"
        blocks.append((sd[f"{cb}.conv.weight"], sd[f"{cb}.conv.lin.weight"].T,
                       _bn(sd, f"{cb}.norm")))
    skip = (sd[f"{base}.conv_block2.lin.mlp.weight"].T,
            sd[f"{base}.conv_block2.lin.mlp.bias"],
            _bn(sd, f"{base}.conv_block2.norm_skip"))
    return blocks, skip


def _edge_attr(pos, pos_nbr, nbr_mask, cart_max):
    a = (pos[:, None, :2] - pos_nbr) / (2.0 * cart_max) + 0.5
    return torch.where(nbr_mask[..., None], torch.clamp(a, 0.0, 1.0), 0.5)


def _layer(sd, li: int, g: Graph, geo: Geometry, q: Q):
    """Layer ``li`` (two conv blocks, BN, activation, the linear skip) on
    ``g``; returns ``(g', neighbour positions [N, K', 2])``."""
    (w1, r1, bn1), (w2, r2, bn2) = _layer_params(sd, li)[0]
    skip_w, skip_b, skip_bn = _layer_params(sd, li)[1]
    act = {"relu": torch.relu, "elu": F.elu,
           "hardtanh": lambda v: torch.clamp(v, -1.0, 1.0),
           "silu": F.silu}[geo.activation]
    cart = geo.cart_max()[li]
    ks = geo.kernel_size
    x_in = q(g.x)
    mask = g.node_mask
    w, h = geo.model_width, geo.model_height
    if li == 0:
        fold = geo.aggr == "sum"
        s0 = 1 if fold else 0
        nbr, nbrm = g.nbr[:, s0:], g.nbr_mask[:, s0:]
        offk = g.off[:, s0:]
        s = torch.tensor((1.0 / (2.0 * cart * w), 1.0 / (2.0 * cart * h)),
                         device=x_in.device)
        attr = torch.where(nbrm[..., None], torch.clamp(
            offk.to(torch.float32) * s + 0.5, 0.0, 1.0), 0.5)
        wh = torch.tensor((w, h), dtype=torch.float32, device=x_in.device)
        ipos = torch.round(g.pos[:, :2] * wh).to(torch.int32)
        pos_nbr = (ipos[:, None, :] - offk).to(torch.float32) / wh
        sx = geo.radius_px / w / (2.0 * cart)
        sy = geo.radius_px / h / (2.0 * cart)
        attr_range = ((0.5 - sx, 0.5 + sx), (0.5 - sy, 0.5 + sy))
        idx = torch.where(nbrm, nbr, 0).long()

        def rows(src):
            return torch.where(nbrm[..., None], src[idx], 0.0)
        x_j1 = rows(x_in)
    else:
        fold, nbrm, attr_range = False, g.nbr_mask, None
        grid = geo.grid_dims()[li - 1]

        def rows(src):
            return grid_rows(src, grid, geo.batch_size)
        both = rows(torch.cat([g.pos[:, :2], x_in], 1))
        pos_nbr, x_j1 = both[..., :2], both[..., 2:]
        attr = _edge_attr(g.pos, pos_nbr, nbrm, cart)
    kw = dict(ks=ks, aggr=geo.aggr, node_mask=mask, attr_range=attr_range,
              fold_center=fold, q=q)
    hh = act(q(batch_norm(spline_conv(x_in, x_j1, nbrm, attr, w1, r1, **kw),
                          mask, bn1)))
    hh = q(torch.where(mask[:, None], hh, 0.0))
    h2 = q(batch_norm(spline_conv(hh, rows(hh), nbrm, attr, w2, r2, **kw),
                      mask, bn2))
    skip = q(batch_norm(q(x_in @ q(skip_w) + skip_b), mask, skip_bn))
    return g._replace(x=q(torch.where(mask[:, None], act(h2 + skip),
                                      0.0))), pos_nbr


def gnn(sd, g0: Graph, feats, geo: Geometry, q: Q = f32, *,
        start_level: int = 0, pos_src0=None):
    """The levels ``start_level``..4 on ``g0``; returns ``(out3, out4)``.
    ``start_level`` 1 resumes from a level-0 output graph with its
    image rows already joined, ``pos_src0 [N, K, 2]`` its edges' source
    positions (the incremental stream's caches)."""
    g = g0
    rows01, c0 = None, 0
    if geo.use_image and start_level == 0:
        c0 = feats[0].shape[-1]
        rows01 = torch.cat([upsampled_rows(f, g0.pos, g0.batch,
                                           geo.model_width, geo.model_height)
                            for f in feats[:2]], 1)

    def cat_image(g, level):
        if not geo.use_image:
            return g
        if level == 0:
            f = rows01[:, :c0]
        elif level == 1:
            f = rows01[:, c0:]
        else:
            f = bilinear_rows(feats[level], g.pos, g.batch, g.node_mask,
                              geo.model_width, geo.model_height)
        return g._replace(x=torch.cat([g.x, q(f)], 1))

    def cat_rel(g):
        rel = torch.where(g.node_mask[:, None], g.pos[:, :2], 0.0)
        return g._replace(x=torch.cat([g.x, rel], 1))
    outs = []
    pos_nbr = pos_src0
    for level in range(start_level, 5):
        if level == 0 or level > start_level:
            g = cat_image(g, level)
        if level > 0:
            s0 = g.nbr.shape[1] - pos_nbr.shape[1]
            g = pool(g._replace(nbr=g.nbr[:, s0:],
                                nbr_mask=g.nbr_mask[:, s0:]), pos_nbr,
                     grid=geo.grid_dims()[level - 1],
                     batch_size=geo.batch_size, width=geo.model_width,
                     height=geo.model_height,
                     aggr="mean" if level == 4 else geo.pooling_aggr,
                     keep_temporal_ordering=geo.keep_temporal_ordering)
        g, pos_nbr = _layer(sd, level, cat_rel(g), geo, q)
        if level >= 3:
            outs.append(g)
    return tuple(outs)


# ---------------------------------------------------------------------------
# box features and the recurrent head
# ---------------------------------------------------------------------------
def box_features(out4: Graph, boxes, box_present, geo: Geometry):
    """``boxes [B, 2, S, 4]`` xywh pixels -> ``[B, 2, S, C]``: the
    distance-weighted mean of the nodes in the box, else the mean of the
    five nearest nodes of the item, else the item's mean."""
    x, posn, nmask = out4.x, out4.pos[:, :2], out4.node_mask
    nbatch = out4.batch.long()
    c = x.shape[1]
    b, nf, s, _ = boxes.shape
    bs, w, h = geo.batch_size, geo.model_width, geo.model_height
    dev = x.device
    xm = torch.where(nmask[:, None], x, 0.0)
    gsum = torch.zeros((bs, c), device=dev).index_add_(0, nbatch, xm)
    gcnt = torch.zeros((bs,), device=dev).index_add_(
        0, nbatch, nmask.to(torch.float32))
    gfeat = gsum / gcnt.clamp(min=1.0)[:, None]
    x1, y1 = boxes[..., 0] / w, boxes[..., 1] / h
    x2 = (boxes[..., 0] + boxes[..., 2]) / w
    y2 = (boxes[..., 1] + boxes[..., 3]) / h
    bx1, by1, bx2, by2 = (v.reshape(-1) for v in (x1, y1, x2, y2))
    bcx = (0.5 * (x1 + x2)).reshape(-1)
    bcy = (0.5 * (y1 + y2)).reshape(-1)
    bb = torch.arange(b, device=dev)[:, None, None].expand(b, nf, s) \
        .reshape(-1)
    px, py = posn[None, :, 0], posn[None, :, 1]
    same_b = (nbatch[None, :] == bb[:, None]) & nmask[None, :]
    in_box = (same_b & (px >= bx1[:, None]) & (px <= bx2[:, None])
              & (py >= by1[:, None]) & (py <= by2[:, None]))
    d = torch.sqrt((px - bcx[:, None]) ** 2 + (py - bcy[:, None]) ** 2)
    w_in = torch.where(in_box, 1.0 / (d + 1e-6), 0.0)
    w_in = w_in / w_in.sum(dim=1, keepdim=True).clamp(min=1e-30)
    feat_in = w_in @ xm
    srt = torch.sort(torch.where(same_b, d, torch.inf), dim=1, stable=True)
    idx5 = srt.indices[:, :5]
    ok5 = torch.isfinite(srt.values[:, :5])
    feat_knn = ((x[idx5] * ok5[..., None]).sum(dim=1)
                / ok5.sum(dim=1, keepdim=True).clamp(min=1))
    feat = torch.where(in_box.any(dim=1)[:, None], feat_in,
                       torch.where((gcnt > 0)[bb][:, None], feat_knn,
                                   gfeat[bb]))
    return torch.where(box_present[..., None], feat.reshape(b, nf, s, c),
                       0.0)


def _gru(sd, prefix: str, n_layers: int, x, h, drop=None):
    """One step of a multi-layer GRU (torch.nn.GRU gates) over all slots:
    ``x [S, In]``, ``h [S, L, H]`` -> ``(out, h')``; ``drop(v)`` between
    layers."""
    hs, inp = [], x
    for i in range(n_layers):
        gi = inp @ sd[f"{prefix}.weight_ih_l{i}"].T + sd[f"{prefix}.bias_ih_l{i}"]
        gh = (h[:, i] @ sd[f"{prefix}.weight_hh_l{i}"].T
              + sd[f"{prefix}.bias_hh_l{i}"])
        ir, iz, inn = gi.chunk(3, dim=-1)
        hr, hz, hn = gh.chunk(3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        inp = (1.0 - z) * torch.tanh(inn + r * hn) + z * h[:, i]
        hs.append(inp)
        if drop is not None and i < n_layers - 1:
            inp = drop(inp)
    return inp, torch.stack(hs, dim=1)


def _linear(sd, key, x):
    return x @ sd[f"{key}.weight"].T + sd[f"{key}.bias"]


def head_step(sd, geo: Geometry, feat, coord, valid, state, drop=None):
    """One item through the head: ``feat [S, x_dim]``, ``coord [S, 4]``,
    the slots ``valid [S]`` that update the track state ``state =
    (h_event, h_coord, seen)``; returns ``(logits [S, 2], state')``."""
    h_event, h_coord, seen = state
    h_in_e = torch.where(seen[:, None, None], h_event, 0.0)
    h_in_c = torch.where(seen[:, None, None], h_coord, 0.0)
    out_e, h_out_e = _gru(sd, "gru_net_event.gru", geo.event_layers, feat,
                          h_in_e, drop)
    out_c, h_out_c = _gru(sd, "gru_net_cor.gru", geo.coord_layers, coord,
                          h_in_c)
    e = _linear(sd, "fusion_module.event_proj", out_e)
    c = _linear(sd, "fusion_module.coord_proj", out_c)
    hh = torch.relu(_linear(sd, "fusion_module.fusion.0",
                            torch.cat([e, c], -1)))
    if drop is not None:
        hh = drop(hh)
    logits = _linear(sd, "fusion_module.fusion.3", hh)

    def attend(hs, w):
        score = (torch.tanh(hs) @ w).squeeze(-1)
        score = torch.where(valid[:, None], score, -torch.inf)
        alpha = torch.where(valid[:, None], torch.softmax(score, dim=0), 0.0)
        return hs * alpha[..., None]
    h_event = torch.where(valid[:, None, None],
                          attend(h_out_e, sd["soft_attention.weight"]),
                          h_event)
    h_coord = torch.where(valid[:, None, None],
                          attend(h_out_c, sd["soft_attention_cor.weight"]),
                          h_coord)
    return logits, (h_event, h_coord, seen | valid)


def empty_state(geo: Geometry, dev) -> tuple:
    s1 = geo.max_boxes + 1
    return (torch.zeros((s1, geo.event_layers, geo.h_dim), device=dev),
            torch.zeros((s1, geo.coord_layers, geo.coord_dim), device=dev),
            torch.zeros((s1,), dtype=torch.bool, device=dev))


def head(sd, geo: Geometry, feats, coords, present):
    """The items of a batch in order through the head (the track state
    flows from item to item): ``(logits [B, S, 2], valid [B, S])``."""
    s1 = feats.shape[2]
    slot = torch.arange(s1, device=feats.device)
    valid = (present & (feats[:, 1].abs().sum(-1) > 0)
             & ((slot >= 1) & (slot <= geo.max_boxes))[None, :])
    state = empty_state(geo, feats.device)
    out = []
    for i in range(feats.shape[0]):
        lg, state = head_step(sd, geo, feats[i, 1], coords[i], valid[i],
                              state)
        out.append(lg)
    return torch.stack(out), valid


def to_device(batch: dict, dev) -> dict:
    """The collated numpy arrays as tensors on ``dev``."""
    return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()
            if isinstance(v, np.ndarray)}


def score(sd, batch: dict, geo: Geometry, q: Q = f32):
    """The logits ``[B, S, 2]`` and valid slots ``[B, S]`` of a collated
    batch (tensors on the weights' device)."""
    with torch.no_grad():
        g0 = level0_graph(batch, geo)
        feats = (cnn_features(sd, batch["image"], geo, q)
                 if geo.use_image else None)
        _, out4 = gnn(sd, g0, feats, geo, q)
        bf = box_features(out4, batch["boxes"], batch["box_present"], geo)
        wh = torch.tensor((geo.model_width, geo.model_height,
                           geo.model_width, geo.model_height),
                          dtype=torch.float32, device=bf.device)
        return head(sd, geo, bf, batch["boxes"][:, 1] / wh,
                    batch["box_present"][:, 1])
