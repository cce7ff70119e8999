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
from eventad_tpu_torch.ops.spline_shift import (prepare_shift,
                                                shift_spline_conv_cuda,
                                                shift_spline_conv_plain,
                                                tap_windows)
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
    with pytest.raises(ValueError, match="output channels"):
        shift_spline_conv_cuda(xt, prep, t["w"][..., :12], t["r"][:, :12],
                               t["a"][:12], t["b"][:12], act="relu")
