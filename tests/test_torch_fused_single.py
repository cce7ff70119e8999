"""K5, the generic single-block fused conv: the port's plain version against
the JAX package's Pallas kernel ``fused_spline_conv_prepared`` in interpret
mode and against its XLA ``spline_conv``, and the port's ``base`` flavour of
``apply_layer`` (two K5 blocks with root, BN, activation and skip around
them) against the JAX package's non-fused bf16 layer.  The CUDA kernel is
held against this plain version on the card by ``chip_smoke.py``."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventad_tpu.models import backbone as jbb
from eventad_tpu.models.dagr import build_level0_graph as jax_level0
from eventad_tpu.models.graph import Graph as JaxGraph
from eventad_tpu.ops.spline_conv import (SplineConvParams,
                                         spline_conv as jax_spline_conv)
from eventad_tpu.ops.spline_fused import (fused_spline_conv_prepared,
                                          prepare_fused as jax_prepare)
from eventad_tpu_torch.models import backbone as tbb
from eventad_tpu_torch.models.dagr import graph_static_config
from eventad_tpu_torch.models.graph import Graph
from eventad_tpu_torch.ops.spline_conv import (center_index,
                                               sub_kernel_index, tap_ranges)
from eventad_tpu_torch.ops.spline_fused import (fused_spline_conv,
                                                fused_spline_conv_cuda,
                                                fused_spline_conv_plain,
                                                pack_fused_weights,
                                                prepare_fused,
                                                unpack_fused_weights)
from test_torch_spline_fused import (_fixture, _jax_layer, _layer_arrays,
                                     _rel, _torch_layer)

import _torch_threads  # noqa: F401  (one intra-op thread)

KS = 5
# the kernel's operands are bf16 (source, weights, z): against the Pallas
# kernel only the f32 summation order differs, against the f32 XLA chain the
# quantisation shows (the band of tests/test_spline_fused.py)
INTERPRET_TOL = 2e-3
XLA_TOL = 3e-2
LAYER_TOL = 2e-2     # of the output scale, two bf16 programs

CASES = {
    # level 0: no lookahead, the 3 x 5 tap sub-rectangle, self edge folded
    # out (K = 15), a stretch of rows without any edge
    "level0": dict(n=256, k=15, cin=19, cout=16, span=(0.2, 0.3),
                   lookback=128, lookahead=0, empty=(100, 180)),
    # a pooled level: neighbours on both sides (2 * nx + 2 rows for
    # nx = 14), all 25 taps
    "pooled": dict(n=140, k=25, cin=82, cout=64, span=(0.5, 0.5),
                   lookback=30, lookahead=30, empty=(0, 0)),
    # widths the launcher before the tensor-core kernel refused or nearly
    # refused: O 136 (two column groups, the last ragged), C 67 (no
    # multiple of 8)
    "wide": dict(n=64, k=25, cin=67, cout=136, span=(0.5, 0.5),
                 lookback=20, lookahead=20, empty=(10, 20)),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    c = CASES[name]
    rng = np.random.RandomState(7)
    n, k = c["n"], c["k"]
    lo = np.maximum(np.arange(n)[:, None] - c["lookback"], 0)
    hi = np.minimum(np.arange(n)[:, None] + c["lookahead"], n - 1)
    nbr = (lo + np.round(rng.rand(n, k) * (hi - lo))).astype(np.int32)
    mask = rng.rand(n, k) > 0.25
    mask[c["empty"][0]:c["empty"][1]] = False
    span = np.array(c["span"])
    attr_range = tuple((0.5 - s, 0.5 + s) for s in c["span"])
    attr = (0.5 + (rng.rand(n, k, 2) * 2 - 1) * span).astype(np.float32)
    attr[::5] = 0.5            # exact taps
    x = rng.randn(n, c["cin"]).astype(np.float32)
    w = (rng.randn(KS * KS, c["cin"], c["cout"])
         / np.sqrt(c["cin"] * 4)).astype(np.float32)
    ranges = tap_ranges(KS, attr_range)
    u = (np.clip(attr, 0, 1) * (KS - 1)).astype(np.float32)
    prep = prepare_fused(torch.from_numpy(nbr), torch.from_numpy(mask),
                         torch.from_numpy(u))
    xb, tw = torch.from_numpy(x).bfloat16(), torch.from_numpy(w)
    got = fused_spline_conv_plain(xb, prep, tw, kernel_size=KS,
                                  ranges=ranges)
    pack = pack_fused_weights(tw, kernel_size=KS, ranges=ranges)
    got_pack = fused_spline_conv_plain(xb, prep, tw, kernel_size=KS,
                                       ranges=ranges, pack=pack)
    return dict(c, nbr=nbr, mask=mask, attr=attr, attr_range=attr_range,
                x=x, w=w, u=u, ranges=ranges, got=got.numpy(),
                got_pack=got_pack.numpy())


@functools.lru_cache(maxsize=None)
def _pallas(name):
    """The Pallas kernel in interpret mode on the case's inputs."""
    c = _case(name)
    jp = jax_prepare(jnp.asarray(c["nbr"]), jnp.asarray(c["mask"]),
                     jnp.asarray(c["u"]), lookback=c["lookback"],
                     lookahead=c["lookahead"], block=128)
    return np.asarray(fused_spline_conv_prepared(
        jnp.asarray(c["x"]).astype(jnp.bfloat16), jp, jnp.asarray(c["w"]),
        kernel_size=KS, ranges=c["ranges"], interpret=True))


@functools.lru_cache(maxsize=None)
def _xla(name):
    """The JAX package's XLA ``spline_conv`` (f32) on the case's inputs."""
    c = _case(name)
    return np.asarray(jax_spline_conv(
        jnp.asarray(c["x"]), jnp.asarray(c["nbr"]), jnp.asarray(c["mask"]),
        jnp.asarray(c["attr"]),
        SplineConvParams(jnp.asarray(c["w"]), None, None), kernel_size=KS,
        aggr="sum", attr_range=c["attr_range"]))


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas_interpret(name):
    c = _case(name)
    want = _pallas(name)
    assert c["got"].dtype == np.float32
    assert c["got"].shape == (c["n"], c["cout"])
    assert _rel(c["got"], want) < INTERPRET_TOL, _rel(c["got"], want)
    e0, e1 = c["empty"]
    assert (c["got"][e0:e1] == 0).all()
    assert (c["got"] != 0).mean() > 0.5


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_xla_spline_conv(name):
    c = _case(name)
    want = _xla(name)
    assert _rel(c["got"], want) < XLA_TOL, _rel(c["got"], want)


@pytest.mark.parametrize("name", list(CASES))
def test_plain_from_pack_matches_pallas_and_xla(name):
    """The plain version computed from the kernel's pack: the same bits as
    from the weights (the pack holds their bf16 values), so within the same
    bands of the Pallas kernel and of the XLA formulation."""
    c = _case(name)
    np.testing.assert_array_equal(c["got_pack"], c["got"])
    assert _rel(c["got_pack"], _pallas(name)) < INTERPRET_TOL
    assert _rel(c["got_pack"], _xla(name)) < XLA_TOL


@pytest.mark.parametrize("name", list(CASES))
def test_pack_fused_weights_round_trips(name):
    """``pack_fused_weights`` lays the sub-rectangle's taps out transposed
    and padded (``O`` to a multiple of 8, ``C`` to 16 plus 8) with zero
    pads, and ``unpack_fused_weights`` gives back their bf16 values; the
    root is folded with the centre tap in the weights' type."""
    c = _case(name)
    w = torch.from_numpy(c["w"])
    root = torch.from_numpy(c["w"][0] * 0.5)
    pack = pack_fused_weights(w, kernel_size=KS, ranges=c["ranges"],
                              root=root, fold_center=True)
    sub = sub_kernel_index(KS, c["ranges"])
    cin, cout = c["cin"], c["cout"]
    assert pack.taps.dtype == torch.bfloat16
    assert pack.taps.shape == (len(sub), -(-cout // 8) * 8,
                               -(-cin // 16) * 16 + 8)
    assert (pack.c, pack.o) == (cin, cout)
    torch.testing.assert_close(unpack_fused_weights(pack),
                               w[torch.from_numpy(sub)].bfloat16(),
                               rtol=0, atol=0)
    assert not pack.taps[:, cout:].any() and not pack.taps[..., cin:].any()
    torch.testing.assert_close(pack.root, root + w[center_index(KS)],
                               rtol=0, atol=0)
    assert pack_fused_weights(w, kernel_size=KS,
                              ranges=c["ranges"]).root is None


def test_dispatch_and_cuda_wrapper_refuse_cpu_tensors():
    c = _case("level0")
    x = torch.from_numpy(c["x"]).bfloat16()
    prep = prepare_fused(torch.from_numpy(c["nbr"]),
                         torch.from_numpy(c["mask"]),
                         torch.from_numpy(c["u"]))
    w = torch.from_numpy(c["w"])
    out = fused_spline_conv(x, prep, w, kernel_size=KS, ranges=c["ranges"])
    np.testing.assert_array_equal(out.numpy(), c["got"])
    before = fused_spline_conv_cuda.launches
    pack = pack_fused_weights(w, kernel_size=KS, ranges=c["ranges"])
    with pytest.raises(ValueError, match="CUDA"):
        fused_spline_conv_cuda(x, prep, w, kernel_size=KS,
                               ranges=c["ranges"], pack=pack)
    assert fused_spline_conv_cuda.launches == before


def _bf16_layers(rng, cin, cout):
    arrays = _layer_arrays(rng, cin, cout)
    return _jax_layer(arrays), _torch_layer(arrays, cin, cout)


def test_base_layer_level0_matches_jax_bf16(rng):
    """apply_layer on the route of ``fused_two_block`` off on the CPU (K5's
    plain version, twice) against the JAX package's bf16 layer, which on
    the CPU takes its non-fused branch."""
    cfg, b, g, x, bc, _ = _fixture(rng, batch_size=2, events=1024,
                                   lookback=256)
    (params, state), layer = _bf16_layers(rng, 19, 16)
    jg = jax_level0(jnp.asarray(b.pos.numpy()), jnp.asarray(
        b.polarity.numpy()), jnp.asarray(b.valid.numpy()),
        graph_static_config(cfg), jnp.asarray(b.rank.numpy()))
    want, _, _ = jax.jit(lambda p, s, g: jbb.apply_layer(
        p, s, g, cart_max=bc.cart_max[0], kernel_size=KS, aggr="sum",
        activation=jax.nn.relu, training=False, return_pos_nbr=True,
        batch_size=2, gather_lookback=256,
        attr_range=jbb.level0_attr_range(bc), self_slot0=True, width=96,
        height=72, activation_name="relu"))(
            params, state,
            jg._replace(x=jnp.asarray(x).astype(jnp.bfloat16)))
    route = tbb.frozen_route(bc._replace(fused_two_block=False),
                             torch.bfloat16, torch.device("cpu"), False)
    assert route.level0 == "K5"
    before = fused_spline_conv_cuda.launches
    got, pos_nbr = tbb.apply_layer(
        layer, g._replace(x=torch.from_numpy(x).bfloat16()),
        route=route.level0, kernel_size=KS, aggr="sum",
        activation_name="relu", cart_max=bc.cart_max[0], batch_size=2,
        attr_range=tbb.level0_attr_range(bc), self_slot0=True, width=96,
        height=72, gather_lookback=256)
    assert got.x.dtype == torch.bfloat16 and pos_nbr.shape[1] == 15
    assert fused_spline_conv_cuda.launches == before
    want = np.asarray(want.x.astype(jnp.float32))
    assert _rel(got.x.float(), want) < LAYER_TOL, _rel(got.x.float(), want)
    assert (want != 0).mean() > 0.2


def test_base_layer_pooled_matches_jax_bf16(rng):
    """The same at a pooled level (the K5 route, ``fused_shift`` off): a
    14 x 10 cell table with the shift neighbourhood, all 25 taps,
    lookahead."""
    grid, bsz, cin, cout = (14, 10), 2, 82, 64
    m = bsz * grid[0] * grid[1]
    active = rng.rand(m) > 0.2
    pos = rng.rand(m, 3).astype(np.float32)
    cells = np.arange(m)
    cx, cy, cb = cells % 14, (cells // 14) % 10, cells // 140
    pos[:, 0] = (cx + rng.rand(m)) / 14
    pos[:, 1] = (cy + rng.rand(m)) / 10
    offs = np.arange(25)
    nx_, ny_ = cx[:, None] + offs % 5 - 2, cy[:, None] + offs // 5 - 2
    in_fov = (nx_ >= 0) & (nx_ < 14) & (ny_ >= 0) & (ny_ < 10)
    nbr = (cb[:, None] * 140 + np.clip(ny_, 0, 9) * 14
           + np.clip(nx_, 0, 13)).astype(np.int32)
    mask = in_fov & active[:, None] & active[nbr] & (rng.rand(m, 25) > 0.3)
    nbr = np.where(mask, nbr, 0).astype(np.int32)
    x = (rng.randn(m, cin) * active[:, None]).astype(np.float32)
    (params, state), layer = _bf16_layers(rng, cin, cout)
    batch = cb.astype(np.int32)
    jg = JaxGraph(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(pos),
                  jnp.asarray(nbr), jnp.asarray(mask), jnp.asarray(active),
                  jnp.asarray(batch))
    want, _, _ = jax.jit(lambda p, s, g: jbb.apply_layer(
        p, s, g, cart_max=0.3, kernel_size=KS, aggr="sum",
        activation=jax.nn.relu, training=False, return_pos_nbr=True,
        grid=grid, batch_size=bsz, width=96, height=72,
        activation_name="relu"))(params, state, jg)
    tg = Graph(torch.from_numpy(x).bfloat16(), torch.from_numpy(pos),
               torch.from_numpy(nbr), torch.from_numpy(mask),
               torch.from_numpy(active), torch.from_numpy(batch))
    got, _ = tbb.apply_layer(layer, tg, route="K5", kernel_size=KS,
                             aggr="sum", activation_name="relu", cart_max=0.3,
                             grid=grid, batch_size=bsz, width=96, height=72)
    want = np.asarray(want.x.astype(jnp.float32))
    assert _rel(got.x.float(), want) < LAYER_TOL, _rel(got.x.float(), want)
    assert (want != 0).mean() > 0.2


def test_base_packs_kept_on_the_layer(rng):
    """The ``base`` flavour's K5 packs are made once per layer: a second
    call returns the same packs, each block's root holds the centre tap
    folded in bf16, and an in-place change of a weight packs anew."""
    _, layer = _bf16_layers(rng, 19, 16)
    ranges = ((1, 3), (0, 4))
    gen = (KS, ranges, True)
    *_, p1, p2 = tbb.whole_layer_operands(layer, torch.bfloat16,
                                          generic=gen)
    again = tbb.whole_layer_operands(layer, torch.bfloat16, generic=gen)
    assert again[-2] is p1 and again[-1] is p2
    for pack, blk in ((p1, layer.block1), (p2, layer.block2)):
        w = blk.conv.weight.detach().bfloat16()
        want = blk.conv.root.detach().bfloat16() + w[center_index(KS)]
        assert pack.root.dtype == torch.bfloat16
        torch.testing.assert_close(pack.root, want, rtol=0, atol=0)
        torch.testing.assert_close(
            unpack_fused_weights(pack),
            w[torch.from_numpy(sub_kernel_index(KS, ranges))], rtol=0,
            atol=0)
    with torch.no_grad():
        layer.block2.conv.weight.mul_(2)
    *_, q1, q2 = tbb.whole_layer_operands(layer, torch.bfloat16,
                                          generic=gen)
    assert q2 is not p2
    torch.testing.assert_close(unpack_fused_weights(q2).float(),
                               2 * unpack_fused_weights(p2).float(),
                               rtol=0, atol=0)
