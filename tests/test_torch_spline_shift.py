"""K3, one pooled-level conv block: the port's plain version against the
JAX package's ``spline_conv`` over the pooled neighbour table plus the layer
tail (f32), and against its Pallas kernel ``shift_spline_conv`` in interpret
mode (bf16), with and without the skip branch.  The CUDA kernel is held
against this plain version on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventad_tpu.ops.spline_conv import SplineConvParams, spline_conv
from eventad_tpu.ops.spline_shift import (prepare_shift as jprep,
                                          shift_spline_conv as jshift,
                                          tap_windows as jwins)
from eventad_tpu_torch.models.backbone import (Layer, fold_bn_affine,
                                                whole_layer_operands)
from eventad_tpu_torch.ops.spline_shift import (
    MAX_OUT, pack_shift_weights, pad_rows, prepare_shift, shift_spline_conv,
    shift_spline_conv_cuda, shift_spline_conv_packed_plain,
    shift_spline_conv_plain, static_tables, tap_windows)
from tests.test_spline_shift import _pooled_graph

import _torch_threads  # noqa: F401  (one intra-op thread)

F32_TOL = 1e-5      # f32, same math in another summation order
BF16_TOL = 2e-2     # of the output scale (tests/test_spline_shift.py)
GEOM = dict(nx=14, ny=10, bsz=2, span=2, width=112, height=80)


def _case(rng, cin=21, cout=16, ks=5, skip=False, adversarial=False):
    nx, ny = GEOM["nx"], GEOM["ny"]
    cart_max = 2.0 * max(1.0 / nx, 1.0 / ny)
    pos, nbr, mask, active = _pooled_graph(rng, adversarial=adversarial,
                                           **GEOM)
    m = pos.shape[0]
    x = (rng.randn(m, cin) * active[:, None]).astype(np.float32)
    attr = (pos[:, None, :] - pos[nbr]) / (2 * cart_max) + 0.5
    attr = np.where(mask[..., None], np.clip(attr, 0.0, 1.0), 0.5) \
        .astype(np.float32)
    arr = dict(
        w=(rng.randn(ks * ks, cin, cout) / np.sqrt(cin * 4)),
        r=(rng.randn(cin, cout) / np.sqrt(cin)),
        a=(rng.rand(cout) + 0.5), b=(rng.randn(cout) * 0.1),
        sk=(rng.randn(cin, cout) / np.sqrt(cin)),
        a_s=(rng.rand(cout) + 0.5), b_s=(rng.randn(cout) * 0.1))
    arr = {k: v.astype(np.float32) for k, v in arr.items()}
    geo = dict(grid=(nx, ny), span=2, cart_max=cart_max, width=GEOM["width"],
               height=GEOM["height"], kernel_size=ks)
    return x, nbr, mask, active, attr, arr, geo


def _f32_reference(x, nbr, mask, active, attr, arr, ks, skip):
    conv = spline_conv(jnp.asarray(x), jnp.asarray(nbr), jnp.asarray(mask),
                       jnp.asarray(attr),
                       SplineConvParams(jnp.asarray(arr["w"]),
                                        jnp.asarray(arr["r"]), None),
                       kernel_size=ks, aggr="sum",
                       node_mask=jnp.asarray(active))
    pre = np.asarray(conv) * arr["a"] + arr["b"]
    if skip:
        pre = pre + (x @ arr["sk"]) * arr["a_s"] + arr["b_s"]
    return np.where(pre > 0, pre, np.expm1(pre)) * active[:, None]


def _port(x, mask, active, attr, arr, geo, skip, dtype):
    t = {k: torch.from_numpy(v) for k, v in arr.items()}
    u = torch.from_numpy(np.clip(attr, 0, 1) * (geo["kernel_size"] - 1))
    prep = prepare_shift(u, torch.from_numpy(mask),
                         torch.from_numpy(active), **geo)
    xt = torch.from_numpy(x).to(dtype)
    sk = (xt, t["sk"], t["a_s"], t["b_s"]) if skip else None
    return prep, xt, t, sk


@pytest.mark.parametrize("skip,adversarial", [(False, False), (True, False),
                                              (True, True)])
def test_plain_matches_jax_spline_conv_f32(rng, skip, adversarial):
    x, nbr, mask, active, attr, arr, geo = _case(rng, skip=skip,
                                                 adversarial=adversarial)
    want = _f32_reference(x, nbr, mask, active, attr, arr, 5, skip)
    prep, xt, t, sk = _port(x, mask, active, attr, arr, geo, skip,
                            torch.float32)
    got = shift_spline_conv_plain(xt, prep, t["w"], t["r"], t["a"], t["b"],
                                  act="elu", skip=sk).numpy()
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel < F32_TOL, rel


@pytest.mark.parametrize("skip", [False, True])
def test_plain_matches_pallas_interpret_bf16(rng, skip):
    x, nbr, mask, active, attr, arr, geo = _case(rng, cout=64, skip=skip)
    prep, xt, t, sk = _port(x, mask, active, attr, arr, geo, skip,
                            torch.bfloat16)
    got = shift_spline_conv_plain(xt, prep, t["w"], t["r"], t["a"], t["b"],
                                  act="relu", skip=sk)
    assert got.dtype == torch.bfloat16
    u = np.clip(attr, 0, 1) * 4
    jp = jprep(jnp.asarray(u), jnp.asarray(mask), jnp.asarray(active),
               block=128, **geo)
    jsk = (jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(arr["sk"]),
           jnp.asarray(arr["a_s"]), jnp.asarray(arr["b_s"])) if skip \
        else None
    want = np.asarray(jshift(
        jnp.asarray(x).astype(jnp.bfloat16), jp, jnp.asarray(arr["w"]),
        jnp.asarray(arr["r"]), jnp.asarray(arr["a"]), jnp.asarray(arr["b"]),
        kernel_size=5, act="relu", skip=jsk, interpret=True), np.float32)
    rel = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert rel < BF16_TOL, rel


def test_tap_lists_match_reference_windows():
    nx, ny = 45, 30
    args = ((nx, ny), 2, 2.0 / 30, 360, 240, 5)
    assert tap_windows(*args) == jwins(*args)
    u = torch.full((2 * nx * ny, 25, 2), 2.0)
    prep = prepare_shift(u, torch.ones(2 * nx * ny, 25, dtype=torch.bool),
                         torch.ones(2 * nx * ny, dtype=torch.bool),
                         grid=(nx, ny), span=2, cart_max=2.0 / 30,
                         width=360, height=240, kernel_size=5)
    wins = tap_windows(*args)
    for ti, (mx, my) in enumerate(prep.tap_mxy.tolist()):
        slots = prep.tap_slots[prep.tap_ptr[ti]:prep.tap_ptr[ti + 1]]
        want = [s for s, ((xl, xh), (yl, yh)) in enumerate(wins)
                if xl <= mx <= xh and yl <= my <= yh]
        assert slots.tolist() == want
        assert prep.tap_idx[ti] == my * 5 + mx
    assert list(prep.d_offs) == [(s // 5 - 2) * nx + s % 5 - 2
                                 for s in range(25)]


def test_cuda_wrapper_refuses_what_it_does_not_take(rng):
    x, nbr, mask, active, attr, arr, geo = _case(rng)
    prep, xt, t, sk = _port(x, mask, active, attr, arr, geo, False,
                            torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        shift_spline_conv_cuda(xt, prep, t["w"], t["r"], t["a"], t["b"],
                               act="relu")
    # any width up to MAX_OUT is taken (then the CPU tensor is refused);
    # a wider one is refused for its width
    with pytest.raises(ValueError, match="CUDA"):
        shift_spline_conv_cuda(xt, prep, t["w"][..., :12], t["r"][:, :12],
                               t["a"][:12], t["b"][:12], act="relu")
    wide = MAX_OUT + 8
    with pytest.raises(ValueError, match="output channels"):
        shift_spline_conv_cuda(xt, prep, t["w"][..., :1].expand(-1, -1, wide),
                               t["r"][:, :1].expand(-1, wide),
                               t["a"][:1].expand(wide),
                               t["b"][:1].expand(wide), act="relu")


def _bf16_operands(t, xt, skip):
    """The operands as the bf16 path hands them over: weights in bf16, the
    affines in f32."""
    bf = torch.bfloat16
    sk = (xt, t["sk"].to(bf), t["a_s"], t["b_s"]) if skip else None
    return (t["w"].to(bf), t["r"].to(bf), t["a"], t["b"]), sk


@pytest.mark.parametrize("skip,cin,cout", [
    (False, 21, 16), (True, 21, 64), (True, 5, 24), (False, 32, 128),
    # widths the kernel takes by padding O to 8 and walking column groups
    (True, 67, 4), (False, 21, 12), (True, 21, 20), (False, 21, 136),
    (True, 67, 256)])
def test_pack_reproduces_plain_exactly(rng, skip, cin, cout):
    """The packed operands (transposed, padded, bf16) hold what the plain
    version is given: computed from the pack, the result is the same bits.
    An ``O`` that is not a multiple of 8 gets zero pad rows, which the
    plain version from the pack does not read."""
    x, nbr, mask, active, attr, arr, geo = _case(rng, cin=cin, cout=cout,
                                                 skip=skip)
    prep, xt, t, _ = _port(x, mask, active, attr, arr, geo, skip,
                           torch.bfloat16)
    ops, sk = _bf16_operands(t, xt, skip)
    pack = pack_shift_weights(prep.tap_idx, *ops, sk)
    n_taps = prep.tap_idx.shape[0]
    stride = -(-cin // 16) * 16 + 8
    rows = -(-cout // 8) * 8
    assert pack.o == cout and pad_rows(cout) == rows
    assert pack.w.shape == (n_taps + 1, rows, stride)
    assert pack.w.dtype == torch.bfloat16 and pack.ab.shape == (rows, 4)
    assert (stride * 2 // 16) % 2 == 1 and (pack.w[..., cin:] == 0).all()
    assert (pack.w[:, cout:] == 0).all() and (pack.ab[cout:] == 0).all()
    assert pack.skip is None or (pack.skip[cout:] == 0).all()
    assert torch.equal(pack.w[n_taps, :cout, :cin].t(), ops[1])
    assert (pack.skip is None) == (not skip) and pack.cs == (cin if skip
                                                              else 0)
    want = shift_spline_conv_plain(xt, prep, *ops, act="elu", skip=sk)
    got = shift_spline_conv_packed_plain(xt, prep, pack, act="elu",
                                         x_skip=xt if skip else None)
    assert torch.equal(got, want)


@pytest.mark.parametrize("skip", [False, True])
def test_kernel_rounding_matches_pallas_interpret_bf16(rng, skip):
    """With ``z`` and the weights rounded to bf16, as the CUDA kernel rounds
    them, the plain version stays inside the Pallas kernel's band."""
    x, nbr, mask, active, attr, arr, geo = _case(rng, cout=64, skip=skip)
    prep, xt, t, sk = _port(x, mask, active, attr, arr, geo, skip,
                            torch.bfloat16)
    got = shift_spline_conv_plain(xt, prep, t["w"], t["r"], t["a"], t["b"],
                                  act="relu", skip=sk, kernel_rounding=True)
    ops, skb = _bf16_operands(t, xt, skip)
    same = shift_spline_conv_packed_plain(
        xt, prep, pack_shift_weights(prep.tap_idx, *ops, skb), act="relu",
        x_skip=xt if skip else None, kernel_rounding=True)
    assert torch.equal(got, same)
    jp = jprep(jnp.asarray(np.clip(attr, 0, 1) * 4), jnp.asarray(mask),
               jnp.asarray(active), block=128, **geo)
    jsk = (jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(arr["sk"]),
           jnp.asarray(arr["a_s"]), jnp.asarray(arr["b_s"])) if skip \
        else None
    want = np.asarray(jshift(
        jnp.asarray(x).astype(jnp.bfloat16), jp, jnp.asarray(arr["w"]),
        jnp.asarray(arr["r"]), jnp.asarray(arr["a"]), jnp.asarray(arr["b"]),
        kernel_size=5, act="relu", skip=jsk, interpret=True), np.float32)
    rel = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert rel < BF16_TOL, rel


def test_static_tables_are_made_once_per_geometry(rng):
    x, nbr, mask, active, attr, arr, geo = _case(rng)
    prep, *_ = _port(x, mask, active, attr, arr, geo, False, torch.bfloat16)
    again, *_ = _port(x, mask, active, attr, arr, geo, False, torch.bfloat16)
    static = ("d_offs", "tap_mxy", "tap_ptr", "tap_slots", "tap_idx",
              "win_mask")
    for name in static:
        assert getattr(prep, name) is getattr(again, name), name
    # a bool edge mask is read as its own bytes, not cast
    assert prep.mq.dtype == torch.uint8
    assert prep.mq.data_ptr() == torch.from_numpy(mask).data_ptr()
    other = static_tables((7, 5), 2, geo["cart_max"], geo["width"],
                          geo["height"], 5, "cpu")
    assert other[0] is not prep.d_offs
    assert other[0].tolist() != prep.d_offs.tolist()


def test_pack_follows_an_in_place_weight_change(rng):
    """The layer keeps its two packs beside its cast operands: the same
    objects while nothing changes, packed anew after an in-place update and
    for another geometry's taps."""
    x, nbr, mask, active, attr, arr, geo = _case(rng, skip=True)
    prep, xt, t, _ = _port(x, mask, active, attr, arr, geo, True,
                           torch.bfloat16)
    bf = torch.bfloat16
    layer = Layer(21, 16, 5, torch.Generator().manual_seed(3))
    ops = whole_layer_operands(layer, bf, prep.tap_idx)
    assert len(ops) == 13
    assert all(p is q for p, q in zip(
        ops, whole_layer_operands(layer, bf, prep.tap_idx)))
    pack1, pack2 = ops[11:]
    h = shift_spline_conv_plain(xt, prep, *ops[:4], act="elu")
    assert torch.equal(h, shift_spline_conv_packed_plain(xt, prep, pack1,
                                                         act="elu"))
    # on the CPU the call site's pack= changes nothing
    assert torch.equal(h, shift_spline_conv(xt, prep, *ops[:4], act="elu",
                                            pack=pack1))
    before = shift_spline_conv_packed_plain(h, prep, pack2, act=None,
                                            x_skip=xt)
    assert torch.equal(before, shift_spline_conv_plain(
        h, prep, *ops[4:8], act=None, skip=(xt,) + ops[8:11]))
    with torch.no_grad():
        for changed in (layer.block2.conv.weight, layer.block2.conv.root,
                        layer.skip_lin):
            changed.mul_(2)
        layer.skip_bn.offset.add_(1.0)
    fresh = whole_layer_operands(layer, bf, prep.tap_idx)
    assert fresh[12] is not pack2
    assert torch.equal(fresh[12].w, pack2.w * 2)
    assert torch.equal(fresh[12].skip, pack2.skip * 2)
    assert torch.equal(fresh[11].w, pack1.w)
    after = shift_spline_conv_packed_plain(h, prep, fresh[12], act=None,
                                           x_skip=xt)
    want = shift_spline_conv_plain(h, prep, *fresh[4:8], act=None,
                                   skip=(xt,) + fresh[8:11])
    assert torch.equal(after, want) and not torch.equal(after, before)
    assert whole_layer_operands(layer, bf, prep.tap_idx)[12] is fresh[12]
    other = static_tables((7, 5), 2, geo["cart_max"], geo["width"],
                          geo["height"], 5, "cpu")[4]
    assert whole_layer_operands(layer, bf, other)[12] is not fresh[12]


@pytest.mark.parametrize("cout", [4, 136, MAX_OUT + 1])
def test_cuda_wrapper_refuses_other_output_widths(rng, cout):
    """Every ``O`` from 1 to ``MAX_OUT`` is a width the kernel takes: the
    pack pads 4 and 136 to a multiple of 8 and the wrapper refuses the call
    only for its CPU tensors; a wider ``O`` it refuses for its width.  No
    refused call launches."""
    x, nbr, mask, active, attr, arr, geo = _case(rng, cout=cout)
    prep, xt, t, sk = _port(x, mask, active, attr, arr, geo, False,
                            torch.bfloat16)
    ops = (t["w"], t["r"], t["a"], t["b"])
    before = shift_spline_conv_cuda.launches
    if cout <= MAX_OUT:
        pack = pack_shift_weights(prep.tap_idx, *ops)
        assert pack.o == cout and pack.w.shape[1] == pad_rows(cout)
        assert pack.w.shape[1] % 8 == 0 and (pack.w[:, cout:] == 0).all()
        with pytest.raises(ValueError, match="CUDA"):
            shift_spline_conv_cuda(xt, prep, *ops, act="relu", pack=pack)
    else:
        with pytest.raises(ValueError, match="output channels"):
            shift_spline_conv_cuda(xt, prep, *ops, act="relu")
    assert shift_spline_conv_cuda.launches == before


def test_padded_pack_matches_pallas_interpret_bf16(rng):
    """At an ``O`` that is not a multiple of 8 (12) and a ``C`` of 67, the
    plain version from the zero-padded pack, rounding where the CUDA kernel
    rounds, stays inside the band of the Pallas kernel, which pads C and O
    itself (interpret mode, bf16, with the skip)."""
    cout = 12
    x, nbr, mask, active, attr, arr, geo = _case(rng, cin=67, cout=cout,
                                                 skip=True)
    prep, xt, t, _ = _port(x, mask, active, attr, arr, geo, True,
                           torch.bfloat16)
    ops, skb = _bf16_operands(t, xt, True)
    pack = pack_shift_weights(prep.tap_idx, *ops, skb)
    assert pack.w.shape[1] == pad_rows(cout) > cout
    got = shift_spline_conv_packed_plain(xt, prep, pack, act="relu",
                                         x_skip=xt, kernel_rounding=True)
    assert got.shape == (x.shape[0], cout)
    jp = jprep(jnp.asarray(np.clip(attr, 0, 1) * 4), jnp.asarray(mask),
               jnp.asarray(active), block=128, **geo)
    jsk = (jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(arr["sk"]),
           jnp.asarray(arr["a_s"]), jnp.asarray(arr["b_s"]))
    want = np.asarray(jshift(
        jnp.asarray(x).astype(jnp.bfloat16), jp, jnp.asarray(arr["w"]),
        jnp.asarray(arr["r"]), jnp.asarray(arr["a"]), jnp.asarray(arr["b"]),
        kernel_size=5, act="relu", skip=jsk, interpret=True), np.float32)
    rel = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert rel < BF16_TOL, rel


def test_whole_layer_operands_follow_in_place_updates():
    """The layer's cast weights and folded BN affines are kept while its
    parameters and buffers are unchanged, and made anew after an in-place
    update of either."""
    layer = Layer(21, 16, 5, torch.Generator().manual_seed(3))
    with torch.no_grad():
        layer.block1.bn.var.uniform_(0.5, 2.0)
        layer.skip_lin_bias.uniform_(-1.0, 1.0)
    bf = torch.bfloat16
    ops = whole_layer_operands(layer, bf)
    assert all(x is y for x, y in zip(ops, whole_layer_operands(layer, bf)))
    w1, root1, a1, c1, w2, root2, a2, c2, skip_lin, a_s, c_s = ops
    assert torch.equal(w1, layer.block1.conv.weight.to(bf))
    assert torch.equal(skip_lin, layer.skip_lin.to(bf))
    for got, want in zip((a1, c1, a_s, c_s), fold_bn_affine(
            layer.block1.bn, None, bf) + fold_bn_affine(
            layer.skip_bn, layer.skip_lin_bias, bf)):
        assert got.dtype == torch.float32 and torch.equal(got, want)
    assert not any(t.requires_grad for t in ops)
    assert whole_layer_operands(layer, torch.float32)[0].dtype \
        == torch.float32
    with torch.no_grad():
        layer.block1.conv.weight.mul_(2)       # a parameter
        layer.block2.bn.mean.add_(1.0)         # a buffer
    fresh = whole_layer_operands(layer, bf)
    assert torch.equal(fresh[0], w1 * 2) and fresh[0] is not w1
    assert not torch.equal(fresh[7], c2)
    assert all(x is y for x, y in zip(fresh,
                                      whole_layer_operands(layer, bf)))
