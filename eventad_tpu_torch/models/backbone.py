"""DAGR backbone — the 5-level GNN pyramid (counterpart of
``eventad_tpu/models/backbone.py``; reference net.py:30-197).

Per level i: [image-feature concat] -> [+rel-xy features] -> Layer_i ->
Pool_i, where ``Layer`` = ConvBlock (spline conv + BN + act) followed by
ConvBlockWithSkip (spline conv + BN, plus linear + BN skip, summed, then
act) (reference conv.py:10-72).

Routing follows the reference's branches: with bf16 compute, sum
aggregation, eval mode and tensors on CUDA, the level-0 layer runs the fused
kernel K2 (``ops/spline_fused``), pooled layers the shift kernel K3
(``ops/spline_shift``) and the level-0/1 image rows K4
(``ops/upsample_flat``); otherwise the non-fused formulation
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
the CPU; the default flags route exactly as before.
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
from ..ops.spline_basis import ACTS
from ..ops.spline_conv import (SplineConv, offset_attr, spline_conv,
                               tap_ranges)
from ..ops import spline_fused
from ..ops.spline_shift import (pack_shift_weights, prepare_shift,
                                shift_spline_conv)
from ..ops.upsample_flat import upsample_rows
from ..utils.spans import span
from ..utils.tensors import constant
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
    each with its root (and centre tap) in ``dt``.  Kept on the layer while
    its parameters and buffers (and ``tap_idx``, ``level0``) are the same
    objects with the same storage and ``_version`` (an in-place update makes
    them anew; a write through ``tensor.data`` does not move ``_version``
    and is not seen), so a forward with unchanged weights casts, folds and
    packs nothing."""
    b1, b2 = layer.block1, layer.block2
    # what the operands are made from, named one by one: walking the module
    # tree (parameters(), buffers()) costs more than the casts it saves
    sources = [b1.conv.weight, b1.conv.root, b2.conv.weight, b2.conv.root,
               layer.skip_lin, layer.skip_lin_bias]
    for bn in (b1.bn, b2.bn, layer.skip_bn):
        sources += [bn.scale, bn.offset, bn.mean, bn.var]
    if tap_idx is not None:
        sources.append(tap_idx)
    key = (dt, level0, generic) + tuple((id(t), t._version, t.data_ptr())
                               for t in sources)
    kept = layer.__dict__.get("_whole_layer_operands")
    if kept is None or kept[0] != key:
        with torch.no_grad():
            a1, c1 = _fold_bn_affine(b1.bn, None, dt)
            a2, c2 = _fold_bn_affine(b2.bn, None, dt)
            a_s, c_s = _fold_bn_affine(layer.skip_bn, layer.skip_lin_bias,
                                       dt)
            ops = tuple(t.detach() for t in (
                b1.conv.weight.to(dt), b1.conv.root.to(dt), a1, c1,
                b2.conv.weight.to(dt), b2.conv.root.to(dt), a2, c2,
                layer.skip_lin.to(dt), a_s, c_s))
            if tap_idx is not None:
                ops += (pack_shift_weights(tap_idx, *ops[:4]),
                        pack_shift_weights(tap_idx, *ops[4:8],
                                           (None,) + ops[8:]))
            if level0 is not None:
                ks, ranges, fold = level0
                kw = dict(kernel_size=ks, ranges=ranges, fold_center=fold)
                ops += (spline_fused.pack_level0_block(*ops[:4], **kw),
                        spline_fused.pack_level0_block(*ops[4:8], **kw,
                                                       skip=ops[8:]))
            if generic is not None:
                ks, ranges, fold = generic
                kw = dict(kernel_size=ks, ranges=ranges, fold_center=fold)
                ops += tuple(spline_fused.pack_fused_weights(
                    w, root=r, **kw) for w, r in (ops[:2], ops[4:6]))
        # tap_idx is held with the key so that no other tensor takes its id
        kept = (key, ops, tap_idx)
        layer.__dict__["_whole_layer_operands"] = kept
    return kept[1]


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
                gather_lookback: int = 0, training: bool = False,
                fused_two_block: bool = True, fused_shift: bool = True):
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
    the cell table (``neighbor_rows``).

    ``training``: BN by batch statistics (running statistics updated in
    place), always through the non-fused formulation.  ``fused_two_block``
    / ``fused_shift``: off selects the generic fused conv K5 for the bf16
    eval layer at level 0 / a pooled level."""
    x_in = g.x
    dt = x_in.dtype
    ks = kernel_size
    act = ACTS[activation_name]
    fold_self = self_slot0 and aggr == "sum"
    s0 = 1 if fold_self else 0
    nbr = g.nbr[:, s0:].contiguous()
    nbr_mask = g.nbr_mask[:, s0:].contiguous()
    fused_act = activation_name in ("relu", "elu", "hardtanh", "silu")
    # K3 (pooled) or K2 (level 0); otherwise the generic conv K5
    use_whole_layer = fused_act and (fused_shift if grid is not None
                                     else fused_two_block)
    use_fused = (dt == torch.bfloat16 and aggr == "sum" and not training
                 and (grid is not None or g.off is not None)
                 and (x_in.is_cuda or not use_whole_layer))
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
        wh = constant((width, height), torch.float32, x_in.device)
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
    node_mask = g.node_mask
    if use_fused:
        u = torch.clamp(attr_f32, 0.0, 1.0) * (ks - 1)
    if use_fused and use_whole_layer:
        if grid is not None:
            prep = prepare_shift(u, nbr_mask, g.node_mask, grid=grid,
                                 span=span, cart_max=cart_max, width=width,
                                 height=height, kernel_size=ks)
            (w1, root1, a1, c1, w2, root2, a2, c2, skip_lin, a_s, c_s,
             pack1, pack2) = whole_layer_operands(layer, dt, prep.tap_idx)
            h = shift_spline_conv(x_in, prep, w1, root1, a1, c1,
                                  act=activation_name, pack=pack1)
            out = shift_spline_conv(h, prep, w2, root2, a2, c2,
                                    act=activation_name,
                                    skip=(x_in, skip_lin, a_s, c_s),
                                    pack=pack2)
        else:
            ranges = (tap_ranges(ks, attr_range) if attr_range
                      else ((0, ks - 1), (0, ks - 1)))
            *_, pack1, pack2 = whole_layer_operands(
                layer, dt, level0=(ks, ranges, fold_self))
            out, _ = spline_fused.fused_two_block(
                x_in, spline_fused.prepare_fused(nbr, nbr_mask, u), pack1,
                pack2, g.node_mask, act=activation_name)
        return g._replace(x=out), pos_nbr

    if use_fused:
        # K5 once per conv block: the neighbour aggregation in the kernel,
        # everything around it in PyTorch ops; the taps packed and the root
        # folded once per layer
        prep = spline_fused.prepare_fused(nbr, nbr_mask, u)
        ranges = (tap_ranges(ks, attr_range) if attr_range
                  else ((0, ks - 1), (0, ks - 1)))
        *_, pack1, pack2 = whole_layer_operands(
            layer, dt, generic=(ks, ranges, fold_self))
        packs = {b1.conv: pack1, b2.conv: pack2}

        def conv_block(src, conv, xj=None):
            pack = packs[conv]
            out = spline_fused.fused_spline_conv(
                src, prep, conv.weight, kernel_size=ks, ranges=ranges,
                pack=pack) + (src @ pack.root).to(torch.float32)
            return torch.where(node_mask[:, None], out, 0.0).to(dt)
    else:
        attr = attr.to(dt)

        def conv_block(src, conv, xj=None):
            return spline_conv(src, nbr, nbr_mask, attr, conv,
                               kernel_size=ks, aggr=aggr,
                               node_mask=node_mask,
                               x_j=rows_of(src) if xj is None else xj,
                               attr_range=attr_range,
                               add_center_to_root=fold_self)

    def norm(x, bn):
        return batch_norm(x, node_mask, bn, training=training)

    h = act(norm(conv_block(x_in, b1.conv, x_j1), b1.bn))
    h = torch.where(node_mask[:, None], h, zero)
    h2 = norm(conv_block(h, b2.conv), b2.bn)
    skip = x_in @ layer.skip_lin.to(dt) + layer.skip_lin_bias.to(dt)
    skip = norm(skip, layer.skip_bn)
    out = torch.where(node_mask[:, None], act(h2 + skip), zero)
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
    # mirrors apply_layer's gate for pooled levels: a fused layer takes the
    # neighbour positions from the pooling's own shift pass
    fused_pooled = (dt == torch.bfloat16 and bc.aggr == "sum"
                    and not training
                    and (g0.x.is_cuda or not bc.fused_shift))

    # levels 0 and 1 both sample at the event positions: one row fetch of
    # the two upsampled maps serves both
    rows01 = None
    c0 = 0
    if bc.use_image and start_level == 0:
        c0 = image_feats[0].shape[-1]
        maps01 = [image_feats[0].to(dt), image_feats[1].to(dt)]
        if bc.bilinear_kernel:
            # one table, each map's sampler writes its column range
            rows01 = torch.empty(
                (g0.pos.shape[0], c0 + maps01[1].shape[-1]), dtype=dt,
                device=g0.pos.device)
            for f, cols in zip(maps01, (rows01[:, :c0], rows01[:, c0:])):
                sample_bilinear(f, g0.pos, g0.node_mask, full_width=bc.width,
                                full_height=bc.height, batch=g0.batch,
                                out=cols)
        elif dt == torch.bfloat16 and not training:
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
                pos_nbr_pre=pos_nbr_pre, gather_lookback=bc.gather_lookback,
                training=training, fused_two_block=bc.fused_two_block,
                fused_shift=bc.fused_shift)
        if level >= 3:
            outs.append(g)
    if end_level < 5 and not outs:
        outs.append(g)
    return tuple(outs)
