"""DAGR backbone — the 5-level GNN pyramid (counterpart of
``eventad_tpu/models/backbone.py``; reference net.py:30-197).

Per level i: [image-feature concat] -> [+rel-xy features] -> Layer_i ->
Pool_i, where ``Layer`` = ConvBlock (spline conv + BN + act) followed by
ConvBlockWithSkip (spline conv + BN, plus linear + BN skip, summed, then
act) (reference conv.py:10-72).

Routing (:func:`frozen_route`, once a forward) follows the reference's
branches: with bf16 compute, sum aggregation, eval mode and tensors on CUDA,
the level-0 layer runs the fused kernel K2 (``ops/spline_fused``), pooled
layers and the GNN head the shift kernel K3 (``ops/spline_shift``), the
level-0/1 image rows K4
(``ops/upsample_flat``) and the image lookup of levels 2-4 the bilinear
sampler K7 (``ops/bilinear_sample``, one launch a level, into the level's
input table); otherwise the non-fused formulation
(``ops/spline_conv`` + ``ops/norm``), as the reference runs f32, training
and CPU, whose level-0 layer fetches its neighbour rows through the windowed
gather K6a (``ops/gather_window``; its backward is K6b).

Three flags of :class:`BackboneConfig` select the other kernel flavours of
the bf16 eval path.  With ``fused_two_block`` off the level-0 layer, and
with ``fused_shift`` off every pooled layer, runs as two launches of the
generic single-block conv K5 (``ops/spline_fused.fused_spline_conv``) with
root, BN, activation, mask and skip in PyTorch ops around them.  With
``bilinear_kernel`` on the level-0/1 image rows come from the bilinear
sampler K7 (``ops/bilinear_sample``), one call per map, instead of K4.  A
flavour asked for by its flag runs on either device (the kernel on the card,
its plain version on the CPU), so it can be held against the reference on
the CPU.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch import nn

from ..config import Config
from ..ops.bilinear_sample import sample_bilinear
from ..ops.gather_window import gather_rows_auto
from ..ops.norm import BatchNorm, batch_norm
from ..ops.pooling import pool_graph
from ..ops.spline_basis import ACT_CODES, ACTS
from ..ops.spline_conv import (SplineConv, offset_attr, spline_conv,
                               tap_ranges)
from ..ops import spline_fused
from ..ops.spline_shift import (pack_shift_weights, prepare_shift,
                                shift_spline_conv)
from ..ops.upsample_flat import upsample_rows
from ..utils.spans import span
from ..utils.tensors import constant, kept_on
from .graph import Graph, neighbor_rows, sample_image_features, \
    upsample_lookup


# the span of each pyramid level (``utils/spans``), named once
LEVEL_SPANS = tuple(f"model/level{i}" for i in range(5))


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
    # the kernel flavours of the bf16 eval path (see the module docstring)
    fused_two_block: bool = True   # level 0: K2; off: two launches of K5
    fused_shift: bool = True       # pooled levels: K3; off: K5
    bilinear_kernel: bool = False  # level-0/1 image rows: K7 instead of K4


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


class Route(NamedTuple):
    """The kernels each frozen stage of a forward takes."""
    level0: str       # "K2" whole layer, "K5" generic conv twice, "plain"
    pooled: str       # "K3" whole layer, "K5" generic conv twice, "plain"
    image_rows: str   # "K7", "K4" or "plain" (``upsample_lookup``)
    pooled_image: str  # levels 2-4: "K7" or "plain" (sample_image_features)


def frozen_route(bc: BackboneConfig, dt: torch.dtype, device: torch.device,
                 training: bool) -> Route:
    """The kernels a forward in ``dt`` on ``device`` takes (the module
    docstring's routing; the GNN head's convs take the pooled layers').  A
    whole-layer kernel needs its flavour flag, an activation the kernels
    apply (``ACT_CODES``) and the card; with its flag off, K5.  The pooled
    levels' image lookup takes K7 in every bf16 eval forward on the card
    (K7 has no backward)."""
    kernels = dt == torch.bfloat16 and bc.aggr == "sum" and not training

    def layer(whole: str, flag: bool) -> str:
        if not kernels:
            return "plain"
        if flag and bc.activation in ACT_CODES:
            return whole if device.type == "cuda" else "plain"
        return "K5"
    rows = ("K7" if bc.bilinear_kernel
            else "K4" if dt == torch.bfloat16 and not training else "plain")
    pooled_image = ("K7" if dt == torch.bfloat16 and not training
                    and device.type == "cuda" else "plain")
    return Route(layer("K2", bc.fused_two_block), layer("K3", bc.fused_shift),
                 rows, pooled_image)


def fold_bn_affine(bn: BatchNorm, bias, dt):
    """Eval BN as an affine ``a*x + b`` in f32 from the parameters in the
    compute dtype ``dt``; a leading bias folds into the offset."""
    f32 = torch.float32
    a = bn.scale.to(dt).to(f32) \
        * torch.reciprocal(torch.sqrt(bn.var.to(f32) + 1e-5))
    b = bn.offset.to(dt).to(f32) - bn.mean.to(f32) * a
    if bias is not None:
        b = b + a * bias.to(dt).to(f32)
    return a, b


def whole_layer_operands(layer: Layer, dt, tap_idx=None,
                         level0=None, generic=None) -> tuple:
    """What the layer kernels (K2, K3, K5) take from ``layer`` in compute
    dtype ``dt``: ``(w1, root1, a1, c1, w2, root2, a2, c2, skip_lin, a_s,
    c_s)``, the weights cast to ``dt`` and the three eval BNs folded into
    f32 affines; with ``tap_idx`` (a pooled level's used taps,
    ``ShiftPrep.tap_idx``) followed by the two conv blocks' ``ShiftWeights``
    for K3; with ``level0 = (kernel_size, ranges, fold_center)`` followed by
    the two conv blocks' ``Level0Weights`` for K2; with ``generic`` (the
    same three) followed by the two conv blocks' ``FusedWeights`` for K5,
    each with its root (and centre tap) in ``dt``.  Kept on the layer
    (``utils/tensors.kept_on``), so a forward with unchanged weights casts,
    folds and packs nothing."""
    b1, b2 = layer.block1, layer.block2
    # what the operands are made from, named one by one: walking the module
    # tree (parameters(), buffers()) costs more than the casts it saves
    sources = [b1.conv.weight, b1.conv.root, b2.conv.weight, b2.conv.root,
               layer.skip_lin, layer.skip_lin_bias]
    for bn in (b1.bn, b2.bn, layer.skip_bn):
        sources += [bn.scale, bn.offset, bn.mean, bn.var]
    if tap_idx is not None:
        sources.append(tap_idx)

    def make():
        a1, c1 = fold_bn_affine(b1.bn, None, dt)
        a2, c2 = fold_bn_affine(b2.bn, None, dt)
        a_s, c_s = fold_bn_affine(layer.skip_bn, layer.skip_lin_bias, dt)
        ops = tuple(t.detach() for t in (
            b1.conv.weight.to(dt), b1.conv.root.to(dt), a1, c1,
            b2.conv.weight.to(dt), b2.conv.root.to(dt), a2, c2,
            layer.skip_lin.to(dt), a_s, c_s))
        if tap_idx is not None:
            ops += (pack_shift_weights(tap_idx, *ops[:4]),
                    pack_shift_weights(tap_idx, *ops[4:8],
                                       (None,) + ops[8:]))
        if level0 is not None or generic is not None:
            ks, ranges, fold = level0 or generic
            kw = dict(kernel_size=ks, ranges=ranges, fold_center=fold)
        if level0 is not None:
            ops += (spline_fused.pack_level0_block(*ops[:4], **kw),
                    spline_fused.pack_level0_block(*ops[4:8], **kw,
                                                   skip=ops[8:]))
        if generic is not None:
            ops += tuple(spline_fused.pack_fused_weights(
                w, root=r, **kw) for w, r in (ops[:2], ops[4:6]))
        return ops
    return kept_on(layer, "whole_layer_operands", sources, make,
                   key=(dt, level0, generic))


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


def _two_blocks(layer: Layer, g: Graph, act_name: str, conv_block, x_j1,
                training: bool):
    """Block 1 (conv, BN, act, mask), block 2 (conv, BN) + skip (linear,
    BN), act, mask around ``conv_block``: the K5 and plain routes."""
    x_in, node_mask = g.x, g.node_mask
    dt = x_in.dtype
    act = ACTS[act_name]
    zero = torch.zeros((), dtype=dt, device=x_in.device)
    b1, b2 = layer.block1, layer.block2

    def norm(x, bn):
        return batch_norm(x, node_mask, bn, training=training)
    h = act(norm(conv_block(x_in, b1.conv, x_j1), b1.bn))
    h = torch.where(node_mask[:, None], h, zero)
    h2 = norm(conv_block(h, b2.conv), b2.bn)
    skip = x_in @ layer.skip_lin.to(dt) + layer.skip_lin_bias.to(dt)
    skip = norm(skip, layer.skip_bn)
    return torch.where(node_mask[:, None], act(h2 + skip), zero)


def _layer_whole(layer: Layer, g: Graph, prep, act: str, level0=None):
    """Routes "K2" (``prep`` a ``FusedPrep``, ``level0`` the packs' key)
    and "K3" (a ``ShiftPrep``): the whole layer in one kernel pair."""
    if level0 is not None:
        *_, pack1, pack2 = whole_layer_operands(layer, g.x.dtype,
                                                level0=level0)
        return spline_fused.fused_two_block(g.x, prep, pack1, pack2,
                                            g.node_mask, act=act)[0]
    (w1, root1, a1, c1, w2, root2, a2, c2, skip_lin, a_s, c_s,
     pack1, pack2) = whole_layer_operands(layer, g.x.dtype, prep.tap_idx)
    h = shift_spline_conv(g.x, prep, w1, root1, a1, c1, act=act, pack=pack1)
    return shift_spline_conv(h, prep, w2, root2, a2, c2, act=act,
                             skip=(g.x, skip_lin, a_s, c_s), pack=pack2)


def _layer_generic(layer: Layer, g: Graph, prep, act: str, generic):
    """Route "K5": the generic conv once per conv block, everything around
    it in PyTorch ops; the taps packed and the root folded once (``generic``
    the packs' key)."""
    dt = g.x.dtype
    ks, ranges, _ = generic
    *_, pack1, pack2 = whole_layer_operands(layer, dt, generic=generic)
    packs = {layer.block1.conv: pack1, layer.block2.conv: pack2}

    def conv_block(src, conv, xj=None):
        pack = packs[conv]
        out = spline_fused.fused_spline_conv(
            src, prep, conv.weight, kernel_size=ks, ranges=ranges,
            pack=pack) + (src @ pack.root).to(torch.float32)
        return torch.where(g.node_mask[:, None], out, 0.0).to(dt)
    return _two_blocks(layer, g, act, conv_block, None, training=False)


def _layer_plain(layer: Layer, g: Graph, nbr, nbr_mask, attr, pos_nbr, *,
                 kernel_size, aggr, act, cart_max, grid, batch_size, span,
                 attr_range, fold_self, gather_lookback, training):
    """Route "plain": ``ops/spline_conv``, neighbour rows from
    ``gather_rows_auto`` (level 0, ``attr`` and ``pos_nbr`` given) or the
    cell table's shifts; returns ``(out, pos_nbr)``."""
    dt = g.x.dtype

    def rows_of(src):
        if grid is not None:
            return neighbor_rows(src, grid, batch_size, span)
        return gather_rows_auto(src, nbr, nbr_mask, lookback=gather_lookback)
    if grid is None:
        x_j1 = rows_of(g.x)
    else:
        rows = rows_of(torch.cat([g.pos[:, :2], g.x.to(torch.float32)], 1))
        pos_nbr, x_j1 = rows[..., :2], rows[..., 2:].to(dt)
        attr = _edge_attr(g.pos, pos_nbr, nbr_mask, cart_max)
    attr = attr.to(dt)

    def conv_block(src, conv, xj=None):
        return spline_conv(src, nbr, nbr_mask, attr, conv,
                           kernel_size=kernel_size, aggr=aggr,
                           node_mask=g.node_mask,
                           x_j=rows_of(src) if xj is None else xj,
                           attr_range=attr_range,
                           add_center_to_root=fold_self)
    return _two_blocks(layer, g, act, conv_block, x_j1, training), pos_nbr


def apply_layer(layer: Layer, g: Graph, *, route: str, kernel_size: int,
                aggr: str, activation_name: str, cart_max: float, grid=None,
                batch_size: int = None, span: int = 2, attr_range=None,
                self_slot0: bool = False, width: int = None,
                height: int = None, pos_nbr_pre=None,
                gather_lookback: int = 0, training: bool = False):
    """One ``Layer`` on graph ``g`` by ``route``, its level's entry of
    :func:`frozen_route`; returns ``(g', pos_nbr)`` where ``pos_nbr [N, K',
    2]`` are the neighbour positions the next pooling reads.

    Level 0 (``grid`` None, ``g.off`` set): attrs and source positions are
    arithmetic from the integer edge offsets; with ``self_slot0`` and sum
    aggregation the self edge (slot 0, attr 0.5) is folded into the root
    products and dropped from the tables (so ``pos_nbr`` has K-1 columns).
    Neighbour rows come from ``gather_rows_auto`` with the window
    ``gather_lookback`` (every ``g.nbr[i, k]`` in ``[i - gather_lookback,
    i]``).  Pooled levels (``grid`` set): neighbour rows are 2-D shifts of
    the cell table (``neighbor_rows``); a kernel route reads ``pos_nbr``
    from the pooling (``pos_nbr_pre``) where given.

    ``training``: BN by batch statistics (running statistics updated in
    place), on the plain route."""
    ks = kernel_size
    fold_self = self_slot0 and aggr == "sum"
    s0 = 1 if fold_self else 0
    nbr = g.nbr[:, s0:].contiguous()
    nbr_mask = g.nbr_mask[:, s0:].contiguous()
    attr = pos_nbr = None
    if grid is None:
        offk = g.off[:, s0:]
        attr = offset_attr(offk, nbr_mask, cart_max, width, height)
        wh = constant((width, height), torch.float32, g.pos.device)
        ipos = torch.round(g.pos[:, :2] * wh).to(torch.int32)
        pos_nbr = (ipos[:, None, :] - offk).to(torch.float32) / wh
    elif route != "plain":
        pos_nbr = (pos_nbr_pre if pos_nbr_pre is not None
                   else neighbor_rows(g.pos[:, :2], grid, batch_size, span))
        attr = _edge_attr(g.pos, pos_nbr, nbr_mask, cart_max)
    if route == "plain":
        out, pos_nbr = _layer_plain(
            layer, g, nbr, nbr_mask, attr, pos_nbr, kernel_size=ks,
            aggr=aggr, act=activation_name, cart_max=cart_max, grid=grid,
            batch_size=batch_size, span=span, attr_range=attr_range,
            fold_self=fold_self, gather_lookback=gather_lookback,
            training=training)
        return g._replace(x=out), pos_nbr
    u = torch.clamp(attr, 0.0, 1.0) * (ks - 1)
    if route == "K3":
        out = _layer_whole(layer, g, prepare_shift(
            u, nbr_mask, g.node_mask, grid=grid, span=span, cart_max=cart_max,
            width=width, height=height, kernel_size=ks), activation_name)
    else:
        prep = spline_fused.prepare_fused(nbr, nbr_mask, u)
        key = (ks, tap_ranges(ks, attr_range or ((0, 1), (0, 1))), fold_self)
        out = (_layer_whole(layer, g, prep, activation_name, level0=key)
               if route == "K2"
               else _layer_generic(layer, g, prep, activation_name, key))
    return g._replace(x=out), pos_nbr


def backbone_forward(backbone: Backbone, g0: Graph,
                     image_feats: Optional[Sequence[torch.Tensor]],
                     bc: BackboneConfig, *, training: bool = False,
                     start_level: int = 0, end_level: int = 5,
                     pos_src0: Optional[torch.Tensor] = None):
    """Runs the 5-level pyramid on the level-0 event graph (``g0.x`` the
    polarity ``[N, 1]``) with the 5 NHWC CNN maps (or None).  Returns
    ``(out3, out4)``, the graphs after layers 4 and 5 (net.py:165-184).
    ``training``: BN by batch statistics in every layer.  Each level runs in
    the span ``model/level<i>``, its pooling in ``model/pool``.

    ``start_level > 0`` resumes the pyramid from a cached intermediate (the
    incremental streaming path): ``g0`` is then the output graph of level
    ``start_level - 1`` with the next level's image features already
    concatenated, and ``pos_src0 [N, K', 2]``, if given, are the neighbour
    positions its first pooling reads (else the pooling reads them through
    ``g0.nbr``).  ``end_level < 5`` stops early; with no output graph
    reached, the last graph is returned alone."""
    dt = torch.bfloat16 if bc.compute_dtype == "bfloat16" else torch.float32
    g = g0._replace(x=g0.x.to(dt))
    route = frozen_route(bc, dt, g0.x.device, training)
    # a kernel route reads the neighbour positions from the pooling's pass
    pos_from_pool = route.pooled != "plain"

    # levels 0 and 1 both sample at the event positions: one row fetch of
    # the two upsampled maps serves both
    rows01 = None
    c0 = 0
    if bc.use_image and start_level == 0:
        c0 = image_feats[0].shape[-1]
        maps01 = [image_feats[0].to(dt), image_feats[1].to(dt)]
        if route.image_rows == "K7":
            # one table, each map's sampler writes its column range
            rows01 = torch.empty(
                (g0.pos.shape[0], c0 + maps01[1].shape[-1]), dtype=dt,
                device=g0.pos.device)
            for f, cols in zip(maps01, (rows01[:, :c0], rows01[:, c0:])):
                sample_bilinear(f, g0.pos, g0.node_mask, full_width=bc.width,
                                full_height=bc.height, batch=g0.batch,
                                out=cols)
        elif route.image_rows == "K4":
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
        elif level == 1 and rows01 is not None:
            f = rows01[:, c0:]
        elif route.pooled_image == "K7":
            # the sampler writes the image columns of the level's input table
            feat = image_feats[level].to(dt)
            cx = g.x.shape[1]
            x = torch.empty((g.x.shape[0], cx + feat.shape[-1]), dtype=dt,
                            device=g.x.device)
            x[:, :cx] = g.x
            sample_bilinear(feat, g.pos, g.node_mask, full_width=bc.width,
                            full_height=bc.height, batch=g.batch,
                            out=x[:, cx:])
            return g._replace(x=x)
        else:
            f = sample_image_features(image_feats[level], g.pos, g.batch,
                                      g.node_mask, bc.width, bc.height)
        return g._replace(x=torch.cat([g.x, f.to(dt)], dim=1))

    def cat_rel(g):
        # reference net.py:122-123: append normalized xy as features
        rel = torch.where(g.node_mask[:, None], g.pos[:, :2], 0.0)
        return g._replace(x=torch.cat([g.x, rel.to(dt)], dim=1))

    outs = []
    pos_nbr = pos_src0
    for level in range(start_level, end_level):
        with span(LEVEL_SPANS[level]):
            pos_nbr_pre = None
            if level > 0:
                # the next level's CNN features are appended at the previous
                # level's node positions, then pooled (net.py:116-169)
                if level > start_level:
                    g = cat_image(g, level)
                aggr = "mean" if level == 4 else bc.pooling_aggr  # net.py:94
                # after the level-0 self-edge fold pos_nbr has K-1 columns:
                # the dropped slot 0 is the self edge, which pooling discards
                s0 = (g.nbr.shape[1] - pos_nbr.shape[1]
                      if pos_nbr is not None else 0)
                with span("model/pool"):
                    g = pool_graph(
                        g.x, g.pos, g.nbr[:, s0:], g.nbr_mask[:, s0:],
                        g.node_mask, g.batch, grid=bc.grids[level - 1],
                        batch_size=bc.batch_size, width=bc.width,
                        height=bc.height, aggr=aggr, span=2,
                        keep_temporal_ordering=bc.keep_temporal_ordering,
                        pos_src=pos_nbr, return_pos_nbr=pos_from_pool)
                if pos_from_pool:
                    g, pos_nbr_pre = g
            else:
                g = cat_image(g, 0)
            g = cat_rel(g)
            g, pos_nbr = apply_layer(
                backbone.layers[level], g,
                route=route.pooled if level > 0 else route.level0,
                kernel_size=bc.kernel_size,
                aggr=bc.aggr, activation_name=bc.activation,
                cart_max=bc.cart_max[level],
                grid=bc.grids[level - 1] if level > 0 else None,
                batch_size=bc.batch_size,
                attr_range=level0_attr_range(bc) if level == 0 else None,
                self_slot0=level == 0, width=bc.width, height=bc.height,
                pos_nbr_pre=pos_nbr_pre, gather_lookback=bc.gather_lookback,
                training=training)
        if level >= 3:
            outs.append(g)
    if end_level < 5 and not outs:
        outs.append(g)
    return tuple(outs)
