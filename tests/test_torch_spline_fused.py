"""K2, the level-0 layer: the port's plain version against the JAX
package's ``apply_layer`` (non-fused branch, f32) and against its Pallas
kernel ``fused_two_block_prepared`` in interpret mode (bf16).  The CUDA
kernel is held against this plain version on the card by
``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventad_tpu.config import Config as JaxConfig
from eventad_tpu.models import backbone as jbb
from eventad_tpu.models.dagr import build_level0_graph as jax_level0
from eventad_tpu.ops.norm import BatchNormParams, BatchNormState
from eventad_tpu.ops.spline_conv import SplineConvParams
from eventad_tpu_torch.config import Config
from eventad_tpu_torch.models import backbone as tbb
from eventad_tpu_torch.models.dagr import (build_level0_graph,
                                           graph_static_config)
from eventad_tpu_torch.data.synthetic import make_synthetic_batch
from eventad_tpu_torch.ops.spline_conv import center_index, tap_ranges
from eventad_tpu_torch.ops.spline_fused import (fused_two_block_cuda,
                                                fused_two_block_plain,
                                                pack_level0_block,
                                                prepare_fused)
from eventad_tpu_torch.ops.spline_shift import MAX_OUT, pad_rows

import _torch_threads  # noqa: F401  (one intra-op thread)

KS = 5
F32_TOL = 1e-5       # f32, same math in another summation order
BF16_TOL = 2e-2      # of the output scale (tests/test_spline_fused.py)


def _layer_arrays(rng, cin, cout):
    def u(*shape, s=1.0):
        return ((rng.rand(*shape) * 2 - 1) * s).astype(np.float32)
    a = {}
    for blk, ci in (("b1", cin), ("b2", cout)):
        a[blk + "_w"] = u(KS * KS, ci, cout, s=1 / np.sqrt(ci * 4))
        a[blk + "_root"] = u(ci, cout, s=1 / np.sqrt(ci))
    for bn in ("b1", "b2", "skip"):
        a[bn + "_scale"] = (rng.rand(cout) + 0.5).astype(np.float32)
        a[bn + "_offset"] = u(cout, s=0.1)
        a[bn + "_mean"] = u(cout, s=0.1)
        a[bn + "_var"] = (rng.rand(cout) + 0.5).astype(np.float32)
    a["skip_lin"] = u(cin, cout, s=1 / np.sqrt(cin))
    a["skip_bias"] = u(cout, s=0.1)
    return a


def _jax_layer(a):
    j = {k: jnp.asarray(v) for k, v in a.items()}

    def blk(p):
        return jbb.ConvBlockParams(
            SplineConvParams(j[p + "_w"], j[p + "_root"], None),
            BatchNormParams(j[p + "_scale"], j[p + "_offset"]))

    def st(p):
        return BatchNormState(j[p + "_mean"], j[p + "_var"])
    params = jbb.LayerParams(blk("b1"), j["skip_lin"], j["skip_bias"],
                             blk("b2"), BatchNormParams(j["skip_scale"],
                                                        j["skip_offset"]))
    state = jbb.LayerState(jbb.ConvBlockState(st("b1")),
                           jbb.ConvBlockState(st("b2")), st("skip"))
    return params, state


def _torch_layer(a, cin, cout):
    layer = tbb.Layer(cin, cout, KS)
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    with torch.no_grad():
        for name, blk in (("b1", layer.block1), ("b2", layer.block2)):
            blk.conv.weight.copy_(t[name + "_w"])
            blk.conv.root.copy_(t[name + "_root"])
        for name, bn in (("b1", layer.block1.bn), ("b2", layer.block2.bn),
                         ("skip", layer.skip_bn)):
            bn.scale.copy_(t[name + "_scale"])
            bn.offset.copy_(t[name + "_offset"])
            bn.mean.copy_(t[name + "_mean"])
            bn.var.copy_(t[name + "_var"])
        layer.skip_lin.copy_(t["skip_lin"])
        layer.skip_lin_bias.copy_(t["skip_bias"])
    return layer.requires_grad_(False)


def _fixture(rng, batch_size=2, events=4096, lookback=512, cin=19, cout=16):
    kw = dict(batch_size=batch_size, width=96, height=72, scale=1,
              event_buckets=(events,), graph_lookback=lookback)
    cfg = Config(**kw)
    b = make_synthetic_batch(cfg, seed=1)
    gsc = graph_static_config(cfg)
    g = build_level0_graph(b.pos, b.polarity, b.valid, gsc, b.rank)
    x = rng.randn(g.pos.shape[0], cin).astype(np.float32)
    bc = tbb.make_backbone_config(cfg)
    return cfg, b, g, x, bc, _layer_arrays(rng, cin, cout)


def _prep_and_params(g, layer, bc, dt=torch.float32):
    """The operands apply_layer hands the fused layer (self edge folded
    into the roots), unpacked as the JAX kernel takes them, and the two
    packs the port's versions take."""
    from eventad_tpu_torch.ops.spline_conv import offset_attr
    attr = offset_attr(g.off[:, 1:], g.nbr_mask[:, 1:], bc.cart_max[0],
                       bc.width, bc.height)
    prep = prepare_fused(g.nbr[:, 1:], g.nbr_mask[:, 1:],
                         attr.clamp(0, 1) * (KS - 1))
    ranges = tap_ranges(KS, tbb.level0_attr_range(bc))
    ci = center_index(KS)
    b1, b2 = layer.block1, layer.block2
    w1, w2 = b1.conv.weight.to(dt), b2.conv.weight.to(dt)
    a1, c1 = tbb.fold_bn_affine(b1.bn, None, dt)
    a2, c2 = tbb.fold_bn_affine(b2.bn, None, dt)
    a_s, c_s = tbb.fold_bn_affine(layer.skip_bn, layer.skip_lin_bias, dt)
    args = (w1, b1.conv.root.to(dt) + w1[ci], a1, c1, w2,
            b2.conv.root.to(dt) + w2[ci])
    epi = (layer.skip_lin.to(dt), a2, c2, a_s, c_s)
    kw = dict(kernel_size=KS, ranges=ranges, fold_center=True)
    packs = (pack_level0_block(w1, b1.conv.root.to(dt), a1, c1, **kw),
             pack_level0_block(w2, b2.conv.root.to(dt), a2, c2, **kw,
                               skip=(epi[0], a_s, c_s)))
    return prep, ranges, args, epi, packs


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want).max() \
        / (np.abs(want).max() + 1e-6)


def test_plain_layer_matches_jax_apply_layer_f32(rng):
    cfg, b, g, x, bc, arrays = _fixture(rng)
    jcfg = JaxConfig(batch_size=2, width=96, height=72, scale=1,
                     event_buckets=(4096,), graph_lookback=512)
    jg = jax_level0(jnp.asarray(b.pos.numpy()), jnp.asarray(
        b.polarity.numpy()), jnp.asarray(b.valid.numpy()),
        graph_static_config(cfg), jnp.asarray(b.rank.numpy()))
    np.testing.assert_array_equal(np.asarray(jg.nbr), g.nbr.numpy())
    np.testing.assert_array_equal(np.asarray(jg.off), g.off.numpy())
    jbc = jbb.make_backbone_config(jcfg)
    params, state = _jax_layer(arrays)
    want, _, _ = jbb.apply_layer(
        params, state, jg._replace(x=jnp.asarray(x)),
        cart_max=jbc.cart_max[0], kernel_size=KS, aggr="sum",
        activation=jax.nn.relu, training=False, return_pos_nbr=True,
        batch_size=2, gather_lookback=512,
        attr_range=jbb.level0_attr_range(jbc), self_slot0=True,
        width=96, height=72, activation_name="relu")
    want = np.asarray(want.x)

    layer = _torch_layer(arrays, 19, 16)
    prep, _, _, _, packs = _prep_and_params(g, layer, bc)
    out, h = fused_two_block_plain(torch.from_numpy(x), prep, *packs,
                                   g.node_mask, act="relu")
    assert out.dtype == torch.float32
    assert _rel(out, want) < F32_TOL, _rel(out, want)
    assert (want != 0).mean() > 0.2

    # and the port's own apply_layer (its non-fused branch on the CPU)
    g2, _ = tbb.apply_layer(layer, g._replace(x=torch.from_numpy(x)),
                            route="plain", kernel_size=KS, aggr="sum",
                            activation_name="relu", cart_max=bc.cart_max[0],
                            batch_size=2, attr_range=tbb.level0_attr_range(
                                bc), self_slot0=True, width=96, height=72)
    assert _rel(g2.x, want) < F32_TOL, _rel(g2.x, want)


def _pallas_interpret_bf16(g, x, prep, ranges, args, epi):
    """The JAX package's K2 in interpret mode, bf16: ``(out, h)``."""
    from eventad_tpu.ops.spline_fused import (fused_two_block_prepared,
                                              prepare_fused as jprep)

    def j(t):
        return jnp.asarray(t.float().numpy())
    mask = g.nbr_mask[:, 1:]
    jp = jprep(jnp.asarray(g.nbr[:, 1:].numpy()), jnp.asarray(mask.numpy()),
               j(prep.u), lookback=128, lookahead=0, block=128)
    return fused_two_block_prepared(
        jnp.asarray(x).astype(jnp.bfloat16), jp, *map(j, args),
        jnp.asarray(g.node_mask.numpy()), kernel_size=KS, ranges=ranges,
        act="relu", epilogue=tuple(map(j, epi)), interpret=True)


def test_plain_layer_matches_pallas_interpret_bf16(rng):
    cfg, b, g, x, bc, arrays = _fixture(rng, batch_size=1, events=1024,
                                        lookback=128)
    layer = _torch_layer(arrays, 19, 16)
    bf16 = torch.bfloat16
    prep, ranges, args, epi, packs = _prep_and_params(g, layer, bc, dt=bf16)
    xb = torch.from_numpy(x).to(bf16)
    out, h = fused_two_block_plain(xb, prep, *packs, g.node_mask,
                                   act="relu")
    assert out.dtype == bf16 and h.dtype == bf16
    want, want_h = _pallas_interpret_bf16(g, x, prep, ranges, args, epi)
    assert _rel(h.float(), want_h) < BF16_TOL, _rel(h.float(), want_h)
    assert _rel(out.float(), want) < BF16_TOL, _rel(out.float(), want)


def test_layer_pack_matches_pallas_and_follows_weights(rng):
    """K2's operands as the layer keeps them (``whole_layer_operands`` with
    ``level0``): fed to the plain version they give the Pallas kernel's
    output in bf16; a second forward gets the same pack objects, and
    ``weight.mul_(2)`` makes them anew with the doubled taps."""
    cfg, b, g, x, bc, arrays = _fixture(rng, batch_size=1, events=1024,
                                        lookback=128)
    layer = _torch_layer(arrays, 19, 16)
    bf16 = torch.bfloat16
    prep, ranges, args, epi, _ = _prep_and_params(g, layer, bc, dt=bf16)
    level0 = (KS, ranges, True)
    ops = tbb.whole_layer_operands(layer, bf16, level0=level0)
    pack1, pack2 = ops[-2:]
    (mx0, mx1), (my0, my1) = ranges
    m = (mx1 - mx0 + 1) * (my1 - my0 + 1)
    assert m < KS * KS
    assert pack1.taps.shape == (m, 16, 40) and pack1.taps.dtype == bf16
    assert pack2.skip is not None and pack2.cs == 19
    xb = torch.from_numpy(x).to(bf16)
    out, h = fused_two_block_plain(xb, prep, pack1, pack2, g.node_mask,
                                   act="relu")
    want, want_h = _pallas_interpret_bf16(g, x, prep, ranges, args, epi)
    assert _rel(h.float(), want_h) < BF16_TOL, _rel(h.float(), want_h)
    assert _rel(out.float(), want) < BF16_TOL, _rel(out.float(), want)

    again = tbb.whole_layer_operands(layer, bf16, level0=level0)
    assert again[-2] is pack1 and again[-1] is pack2
    with torch.no_grad():
        layer.block1.conv.weight.mul_(2)
    fresh = tbb.whole_layer_operands(layer, bf16, level0=level0)
    assert fresh[-2] is not pack1
    assert torch.equal(fresh[-2].taps.float(), 2 * pack1.taps.float())
    moved, _ = fused_two_block_plain(xb, prep, *fresh[-2:], g.node_mask,
                                     act="relu")
    assert not torch.equal(moved, out)


def test_cuda_wrapper_refuses_cpu_tensors(rng):
    _, _, g, x, bc, arrays = _fixture(rng, batch_size=1, events=256,
                                      lookback=64)
    layer = _torch_layer(arrays, 19, 16)
    prep, _, _, _, packs = _prep_and_params(g, layer, bc, dt=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        fused_two_block_cuda(torch.from_numpy(x).bfloat16(), prep, *packs,
                             g.node_mask, act="relu")


def _random_packs(rng, c, o1, o2, ranges, n=300, k=15):
    """A window-local graph of ``n`` rows and the two blocks' packs from
    seeded weights (bf16), block 2 with the skip."""
    rows = np.arange(n)[:, None]
    back = rng.randint(1, 40, (n, k))
    edges = (rng.rand(n, k) < 0.4) & (rows - back >= 0)
    u = rng.rand(n, k, 2).astype(np.float32) * (KS - 1)
    prep = prepare_fused(torch.from_numpy((rows - back).astype(np.int32)),
                         torch.from_numpy(edges), torch.from_numpy(u))
    bf16 = torch.bfloat16

    def w(*shape, fan):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                / np.sqrt(fan)).to(bf16)

    def affine(o):
        return (torch.from_numpy(rng.rand(o).astype(np.float32) + 0.5),
                torch.from_numpy(rng.randn(o).astype(np.float32) * 0.1))
    kw = dict(kernel_size=KS, ranges=ranges, fold_center=True)
    pack1 = pack_level0_block(w(KS * KS, c, o1, fan=4 * c), w(c, o1, fan=c),
                              *affine(o1), **kw)
    pack2 = pack_level0_block(w(KS * KS, o1, o2, fan=4 * o1),
                              w(o1, o2, fan=o1), *affine(o2), **kw,
                              skip=(w(c, o2, fan=c), *affine(o2)))
    src = torch.from_numpy(rng.randn(n, c).astype(np.float32)).to(bf16)
    nodes = torch.from_numpy(rng.rand(n) > 0.1)
    return src, prep, pack1, pack2, nodes


def _unpadded(pk):
    """The pack with its output rows cut to ``O``: the layout without the
    pad rows the kernel's tiles need."""
    o = pk.o
    return pk._replace(taps=pk.taps[:, :o], root=pk.root[:o],
                       skip=None if pk.skip is None else pk.skip[:o],
                       ab=pk.ab[:o])


@pytest.mark.parametrize("c,o1,o2", [(19, 4, 12), (67, 64, 20),
                                     (67, 136, 256), (19, 256, 4)])
def test_padded_packs_reproduce_unpadded_exactly(rng, c, o1, o2):
    """Every ``O`` from 1 to ``MAX_OUT`` and any ``C``: the packs pad the
    output rows to a multiple of 8 with zeros, and the plain version from
    the padded packs gives the same bits as from the packs cut to ``O``."""
    ranges = ((1, 3), (0, 4))
    src, prep, pack1, pack2, nodes = _random_packs(rng, c, o1, o2, ranges)
    for pk, o in ((pack1, o1), (pack2, o2)):
        assert pk.o == o and o <= MAX_OUT
        assert pk.taps.shape[1] == pk.root.shape[0] == pk.ab.shape[0] \
            == pad_rows(o)
        assert (pk.taps[:, o:] == 0).all() and (pk.root[o:] == 0).all()
        assert (pk.ab[o:] == 0).all()
    assert (pack2.skip[o2:] == 0).all()
    out, h = fused_two_block_plain(src, prep, pack1, pack2, nodes,
                                   act="elu")
    want, want_h = fused_two_block_plain(src, prep, _unpadded(pack1),
                                         _unpadded(pack2), nodes, act="elu")
    assert out.shape == (src.shape[0], o2) and h.shape == (src.shape[0], o1)
    assert torch.equal(out, want) and torch.equal(h, want_h)
    assert (out[~nodes] == 0).all() and out.abs().max() > 0


def test_padded_pack_matches_pallas_interpret_bf16(rng):
    """At an ``O`` that is not a multiple of 8 (12), the plain version from
    the layer's zero-padded packs stays inside the band of the Pallas
    kernel, which pads C and O itself (interpret mode, bf16)."""
    cfg, b, g, x, bc, arrays = _fixture(rng, batch_size=1, events=1024,
                                        lookback=128, cout=12)
    layer = _torch_layer(arrays, 19, 12)
    bf16 = torch.bfloat16
    prep, ranges, args, epi, packs = _prep_and_params(g, layer, bc, dt=bf16)
    assert packs[0].taps.shape[1] == 16 and packs[0].o == 12
    out, h = fused_two_block_plain(torch.from_numpy(x).to(bf16), prep,
                                   *packs, g.node_mask, act="relu")
    assert out.shape == h.shape == (x.shape[0], 12)
    want, want_h = _pallas_interpret_bf16(g, x, prep, ranges, args, epi)
    assert _rel(h.float(), want_h) < BF16_TOL, _rel(h.float(), want_h)
    assert _rel(out.float(), want) < BF16_TOL, _rel(out.float(), want)


@pytest.mark.parametrize("aggr", ["sum", "mean"])
def test_spline_conv_and_basis_match(rng, aggr):
    """The non-fused formulation on its own: ``spline_conv`` (full tap
    range, both aggregations) and the degree-1 basis."""
    from eventad_tpu.ops.spline import spline_basis as jbasis
    from eventad_tpu.ops.spline_conv import spline_conv as jconv
    from eventad_tpu_torch.ops.spline import spline_basis
    from eventad_tpu_torch.ops.spline_conv import SplineConv, spline_conv
    n, k, cin, cout = 400, 7, 12, 8
    x = rng.randn(n, cin).astype(np.float32)
    nbr = rng.randint(0, n, (n, k)).astype(np.int32)
    mask = rng.rand(n, k) > 0.3
    attr = rng.rand(n, k, 2).astype(np.float32)
    node_mask = rng.rand(n) > 0.1
    conv = SplineConv(cin, cout, KS, torch.Generator().manual_seed(2))
    conv.requires_grad_(False)
    want = jconv(jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(mask),
                 jnp.asarray(attr),
                 SplineConvParams(jnp.asarray(conv.weight.numpy()),
                                  jnp.asarray(conv.root.numpy()), None),
                 kernel_size=KS, aggr=aggr, node_mask=jnp.asarray(node_mask))
    got = spline_conv(torch.from_numpy(x), torch.from_numpy(nbr),
                      torch.from_numpy(mask), torch.from_numpy(attr), conv,
                      kernel_size=KS, aggr=aggr,
                      node_mask=torch.from_numpy(node_mask))
    assert _rel(got, want) < F32_TOL
    w, idx = spline_basis(torch.from_numpy(attr), KS)
    jw, jidx = jbasis(jnp.asarray(attr), KS)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-7)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
