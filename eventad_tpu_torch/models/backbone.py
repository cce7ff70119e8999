"""DAGR backbone — the 5-level GNN pyramid (counterpart of
``eventad_tpu/models/backbone.py``; reference net.py:30-197).

Per level i: [image-feature concat] -> [+rel-xy features] -> Layer_i ->
Pool_i, where ``Layer`` = ConvBlock (spline conv + BN + act) followed by
ConvBlockWithSkip (spline conv + BN, plus linear + BN skip, summed, then
act) (reference conv.py:10-72).

Routing follows the reference's branches: with bf16 compute, sum
aggregation and tensors on CUDA, the level-0 layer runs the fused kernel K2
(``ops/spline_fused``), pooled layers the shift kernel K3
(``ops/spline_shift``) and the level-0/1 image rows K4
(``ops/upsample_flat``); otherwise the non-fused formulation
(``ops/spline_conv`` + ``ops/norm``), as the reference runs f32 and CPU,
whose level-0 layer fetches its neighbour rows through the windowed gather
K6a (``ops/gather_window``; its backward is K6b).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ..config import Config
from ..ops.gather_window import gather_rows_auto
from ..ops.norm import BatchNorm, batch_norm
from ..ops.pooling import pool_graph
from ..ops.spline_basis import ACTS
from ..ops.spline_conv import (SplineConv, center_index, offset_attr,
                               spline_conv, tap_ranges)
from ..ops.spline_fused import fused_two_block, prepare_fused
from ..ops.spline_shift import prepare_shift, shift_spline_conv
from ..ops.upsample_flat import upsample_rows
from .graph import Graph, neighbor_rows, sample_image_features, \
    upsample_lookup


class ConvBlock(nn.Module):
    def __init__(self, cin, cout, kernel_size, generator):
        super().__init__()
        self.conv = SplineConv(cin, cout, kernel_size, generator)
        self.bn = BatchNorm(cout)


class Layer(nn.Module):
    """reference conv.py:59-72: block1 -> block2 with a linear skip."""

    def __init__(self, cin: int, cout: int, kernel_size: int,
                 generator: torch.Generator = None):
        super().__init__()
        self.block1 = ConvBlock(cin, cout, kernel_size, generator)
        self.block2 = ConvBlock(cout, cout, kernel_size, generator)
        s = 1.0 / cin ** 0.5
        self.skip_lin = nn.Parameter(
            torch.empty(cin, cout).uniform_(-s, s, generator=generator))
        self.skip_lin_bias = nn.Parameter(torch.zeros(cout))
        self.skip_bn = BatchNorm(cout)


class BackboneConfig(NamedTuple):
    """Static geometry derived from :class:`Config`."""
    channels: Tuple[int, ...]
    image_channels: Tuple[int, ...]       # empty if use_image=False
    grids: Tuple[Tuple[int, int], ...]    # 4 pooling grids
    cart_max: Tuple[float, ...]           # attr normalizers per level 0..4
    width: int
    height: int
    batch_size: int
    kernel_size: int
    aggr: str
    activation: str
    pooling_aggr: str
    keep_temporal_ordering: bool
    use_image: bool
    gather_lookback: int = 0   # window of the level-0 neighbour gather
    radius_px: int = 0
    compute_dtype: str = "float32"


def make_backbone_config(cfg: Config) -> BackboneConfig:
    ch = cfg.channels()
    eff = cfg.effective_radius
    poolings = cfg.poolings()
    cart = [eff, 2 * eff] + [2 * max(p[0], p[1]) for p in poolings[1:]]
    return BackboneConfig(
        channels=tuple(ch),
        image_channels=tuple(ch[1:]) if cfg.use_image else (),
        grids=tuple(cfg.grid_dims()), cart_max=tuple(cart),
        width=cfg.model_width, height=cfg.model_height,
        batch_size=cfg.batch_size, kernel_size=cfg.kernel_size,
        aggr=cfg.aggr, activation=cfg.activation,
        pooling_aggr=cfg.pooling_aggr,
        keep_temporal_ordering=cfg.keep_temporal_ordering,
        use_image=cfg.use_image, gather_lookback=cfg.graph_lookback,
        radius_px=cfg.radius_px, compute_dtype=cfg.compute_dtype)


def layer_in_out_channels(bc: BackboneConfig):
    """(cin, cout) per layer, reference net.py:58-97."""
    ch = list(bc.channels)
    inputs = ch[:-1]
    if bc.use_image:
        inputs = [inputs[i] + bc.image_channels[i] for i in range(5)]
    return [(inputs[i] + 2, ch[i + 1]) for i in range(5)]


class Backbone(nn.Module):
    def __init__(self, bc: BackboneConfig, generator: torch.Generator = None):
        super().__init__()
        self.layers = nn.ModuleList(
            [Layer(cin, cout, bc.kernel_size, generator)
             for cin, cout in layer_in_out_channels(bc)])


def _fold_bn_affine(bn: BatchNorm, bias, dt):
    """Eval BN as an affine ``a*x + b`` in f32 from the parameters in the
    compute dtype ``dt``; a leading bias folds into the offset."""
    f32 = torch.float32
    a = bn.scale.to(dt).to(f32) \
        * torch.reciprocal(torch.sqrt(bn.var.to(f32) + 1e-5))
    b = bn.offset.to(dt).to(f32) - bn.mean.to(f32) * a
    if bias is not None:
        b = b + a * bias.to(dt).to(f32)
    return a, b


def level0_attr_range(bc: BackboneConfig):
    """Static level-0 attr bounds from the graph contract (every edge's
    pixel offset satisfies ``|dx|, |dy| <= radius_px``): a narrow band
    around 0.5, which confines the spline contraction to a tap
    sub-rectangle (3 x 5 of 5 x 5 at 360 x 240).  None without a radius."""
    if bc.radius_px <= 0:
        return None
    sx = bc.radius_px / bc.width / (2.0 * bc.cart_max[0])
    sy = bc.radius_px / bc.height / (2.0 * bc.cart_max[0])
    return ((0.5 - sx, 0.5 + sx), (0.5 - sy, 0.5 + sy))


def _edge_attr(pos, pos_nbr, nbr_mask, cart_max):
    a = (pos[:, None, :2] - pos_nbr) / (2.0 * cart_max) + 0.5
    return torch.where(nbr_mask[..., None], torch.clamp(a, 0.0, 1.0), 0.5)


def apply_layer(layer: Layer, g: Graph, *, kernel_size: int, aggr: str,
                activation_name: str, cart_max: float, grid=None,
                batch_size: int = None, span: int = 2, attr_range=None,
                self_slot0: bool = False, width: int = None,
                height: int = None, pos_nbr_pre=None,
                gather_lookback: int = 0):
    """One ``Layer`` on graph ``g``; returns ``(g', pos_nbr)`` where
    ``pos_nbr [N, K', 2]`` are the neighbour positions the next pooling
    reads.

    Level 0 (``grid`` None, ``g.off`` set): attrs and source positions are
    arithmetic from the integer edge offsets; with ``self_slot0`` and sum
    aggregation the self edge (slot 0, attr 0.5) is folded into the root
    products and dropped from the tables (so ``pos_nbr`` has K-1 columns).
    Neighbour rows come from ``gather_rows_auto`` with the window
    ``gather_lookback`` (every ``g.nbr[i, k]`` in ``[i - gather_lookback,
    i]``).  Pooled levels (``grid`` set): neighbour rows are 2-D shifts of
    the cell table (``neighbor_rows``)."""
    x_in = g.x
    dt = x_in.dtype
    ks = kernel_size
    act = ACTS[activation_name]
    fold_self = self_slot0 and aggr == "sum"
    s0 = 1 if fold_self else 0
    nbr = g.nbr[:, s0:].contiguous()
    nbr_mask = g.nbr_mask[:, s0:].contiguous()
    use_fused = (dt == torch.bfloat16 and aggr == "sum" and x_in.is_cuda
                 and (grid is not None or g.off is not None))
    zero = torch.zeros((), dtype=dt, device=x_in.device)

    def rows_of(src):
        if grid is not None:
            return neighbor_rows(src, grid, batch_size, span)
        return gather_rows_auto(src, nbr, nbr_mask, lookback=gather_lookback)

    x_j1 = None
    if g.off is not None and grid is None:
        offk = g.off[:, s0:]
        attr = offset_attr(offk, nbr_mask, cart_max, width, height)
        if not use_fused:
            x_j1 = rows_of(x_in)
        wh = torch.tensor([width, height], dtype=torch.float32,
                          device=x_in.device)
        ipos = torch.round(g.pos[:, :2] * wh).to(torch.int32)
        pos_nbr = (ipos[:, None, :] - offk).to(torch.float32) / wh
    elif use_fused:
        pos_nbr = (pos_nbr_pre if pos_nbr_pre is not None
                   else neighbor_rows(g.pos[:, :2], grid, batch_size, span))
        attr = _edge_attr(g.pos, pos_nbr, nbr_mask, cart_max)
    else:
        src = torch.cat([g.pos[:, :2], x_in.to(torch.float32)], dim=1)
        rows = rows_of(src)
        pos_nbr = rows[..., :2]
        x_j1 = rows[..., 2:].to(dt)
        attr = _edge_attr(g.pos, pos_nbr, nbr_mask, cart_max)
    attr_f32 = attr

    b1, b2 = layer.block1, layer.block2
    if use_fused:
        u = torch.clamp(attr_f32, 0.0, 1.0) * (ks - 1)
        w1, w2 = b1.conv.weight.to(dt), b2.conv.weight.to(dt)
        root1, root2 = b1.conv.root.to(dt), b2.conv.root.to(dt)
        a1, c1 = _fold_bn_affine(b1.bn, None, dt)
        a2, c2 = _fold_bn_affine(b2.bn, None, dt)
        a_s, c_s = _fold_bn_affine(layer.skip_bn, layer.skip_lin_bias, dt)
        skip_lin = layer.skip_lin.to(dt)
        if grid is not None:
            prep = prepare_shift(u, nbr_mask, g.node_mask, grid=grid,
                                 span=span, cart_max=cart_max, width=width,
                                 height=height, kernel_size=ks)
            h = shift_spline_conv(x_in, prep, w1, root1, a1, c1,
                                  act=activation_name)
            out = shift_spline_conv(h, prep, w2, root2, a2, c2,
                                    act=activation_name,
                                    skip=(x_in, skip_lin, a_s, c_s))
        else:
            ranges = (tap_ranges(ks, attr_range) if attr_range
                      else ((0, ks - 1), (0, ks - 1)))
            if fold_self:
                ci = center_index(ks)
                root1 = root1 + w1[ci]
                root2 = root2 + w2[ci]
            out, _ = fused_two_block(
                x_in, prepare_fused(nbr, nbr_mask, u), w1, root1, a1, c1,
                w2, root2, g.node_mask, kernel_size=ks, ranges=ranges,
                act=activation_name,
                epilogue=(skip_lin, a2, c2, a_s, c_s))
        return g._replace(x=out), pos_nbr

    attr = attr.to(dt)
    node_mask = g.node_mask

    def conv_block(src, conv, xj):
        return spline_conv(src, nbr, nbr_mask, attr, conv, kernel_size=ks,
                           aggr=aggr, node_mask=node_mask, x_j=xj,
                           attr_range=attr_range,
                           add_center_to_root=fold_self)

    h = act(batch_norm(conv_block(x_in, b1.conv, x_j1), node_mask, b1.bn))
    h = torch.where(node_mask[:, None], h, zero)
    h2 = batch_norm(conv_block(h, b2.conv, rows_of(h)), node_mask, b2.bn)
    skip = x_in @ layer.skip_lin.to(dt) + layer.skip_lin_bias.to(dt)
    skip = batch_norm(skip, node_mask, layer.skip_bn)
    out = torch.where(node_mask[:, None], act(h2 + skip), zero)
    return g._replace(x=out), pos_nbr


def backbone_forward(backbone: Backbone, g0: Graph,
                     image_feats: Optional[Sequence[torch.Tensor]],
                     bc: BackboneConfig):
    """Runs the 5-level pyramid on the level-0 event graph (``g0.x`` the
    polarity ``[N, 1]``) with the 5 NHWC CNN maps (or None).  Returns
    ``(out3, out4)``, the graphs after layers 4 and 5 (net.py:165-184)."""
    dt = torch.bfloat16 if bc.compute_dtype == "bfloat16" else torch.float32
    g = g0._replace(x=g0.x.to(dt))
    fused_pooled = (dt == torch.bfloat16 and bc.aggr == "sum"
                    and g0.x.is_cuda)

    # levels 0 and 1 both sample at the event positions: one row fetch of
    # the two upsampled maps serves both
    rows01 = None
    c0 = 0
    if bc.use_image:
        c0 = image_feats[0].shape[-1]
        maps01 = [image_feats[0].to(dt), image_feats[1].to(dt)]
        if dt == torch.bfloat16:
            rows01 = upsample_rows(maps01, g0.pos, g0.batch, bc.width,
                                   bc.height)
        else:
            rows01 = upsample_lookup(maps01, g0.pos, g0.batch, g0.node_mask,
                                     bc.width, bc.height, mask_rows=False)

    def cat_image(g, level):
        if not bc.use_image:
            return g
        if level == 0:
            f = rows01[:, :c0]
        elif level == 1:
            f = rows01[:, c0:]
        else:
            f = sample_image_features(image_feats[level], g.pos, g.batch,
                                      g.node_mask, bc.width, bc.height)
        return g._replace(x=torch.cat([g.x, f.to(dt)], dim=1))

    def cat_rel(g):
        # reference net.py:122-123: append normalized xy as features
        rel = torch.where(g.node_mask[:, None], g.pos[:, :2], 0.0)
        return g._replace(x=torch.cat([g.x, rel.to(dt)], dim=1))

    outs = []
    pos_nbr = None
    for level in range(5):
        pos_nbr_pre = None
        if level > 0:
            # the next level's CNN features are appended at the previous
            # level's node positions, then pooled (net.py:116-169)
            g = cat_image(g, level)
            aggr = "mean" if level == 4 else bc.pooling_aggr   # net.py:94
            s0 = g.nbr.shape[1] - pos_nbr.shape[1]
            g = pool_graph(
                g.x, g.pos, g.nbr[:, s0:], g.nbr_mask[:, s0:], g.node_mask,
                g.batch, grid=bc.grids[level - 1], batch_size=bc.batch_size,
                width=bc.width, height=bc.height, aggr=aggr, span=2,
                keep_temporal_ordering=bc.keep_temporal_ordering,
                pos_src=pos_nbr, return_pos_nbr=fused_pooled)
            if fused_pooled:
                g, pos_nbr_pre = g
        else:
            g = cat_image(g, 0)
        g = cat_rel(g)
        g, pos_nbr = apply_layer(
            backbone.layers[level], g, kernel_size=bc.kernel_size,
            aggr=bc.aggr, activation_name=bc.activation,
            cart_max=bc.cart_max[level],
            grid=bc.grids[level - 1] if level > 0 else None,
            batch_size=bc.batch_size,
            attr_range=level0_attr_range(bc) if level == 0 else None,
            self_slot0=level == 0, width=bc.width, height=bc.height,
            pos_nbr_pre=pos_nbr_pre, gather_lookback=bc.gather_lookback)
        if level >= 3:
            outs.append(g)
    return tuple(outs)
