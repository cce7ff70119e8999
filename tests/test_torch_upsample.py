"""K4, the level-0/1 image rows: the port's plain version against the JAX
package's ``upsample_lookup`` (f32) and its Pallas flat-table writer
``upsample_flat_lookup`` in interpret mode (bf16), and its tap tables
against the JAX package's; plus the bilinear lookup of the pooled
levels.  The CUDA kernel is held against this plain
version on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventad_tpu.models.graph import (_interp_matrix,
                                      sample_image_features as jsample,
                                      upsample_lookup as jlookup)
from eventad_tpu.ops.upsample_flat import _taps, upsample_flat_lookup
from eventad_tpu_torch.models.graph import (_interp_matrix as tinterp,
                                            axis_taps, sample_image_features,
                                            upsample_lookup)
from eventad_tpu_torch.ops.upsample_flat import (tap_tables,
                                                 upsample_rows,
                                                 upsample_rows_cuda,
                                                 upsample_rows_plain)

import _torch_threads  # noqa: F401  (one intra-op thread)

B, HF, WF, N = 2, 72, 96, 4096     # fixture geometry


def _inputs(rng, shapes=((36, 48, 16), (18, 24, 64))):
    feats = [rng.randn(B, h, w, c).astype(np.float32) for h, w, c in shapes]
    xi = rng.randint(0, WF, N)
    yi = rng.randint(0, HF, N)
    # normalized as the level-0 graph normalizes: pixel / size in f32
    pos = np.stack([xi / np.float32(WF), yi / np.float32(HF),
                    np.zeros(N)], -1).astype(np.float32)
    batch = rng.randint(0, B, N).astype(np.int32)
    return feats, pos, batch


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return np.abs(np.asarray(got, np.float32) - want).max() \
        / (np.abs(want).max() + 1e-6)


def test_plain_matches_upsample_lookup_f32(rng):
    feats, pos, batch = _inputs(rng)
    got = upsample_rows_plain([torch.from_numpy(f) for f in feats],
                              torch.from_numpy(pos), torch.from_numpy(batch),
                              WF, HF)
    want = jlookup([jnp.asarray(f) for f in feats], jnp.asarray(pos),
                   jnp.asarray(batch), jnp.ones(N, bool), WF, HF,
                   mask_rows=False)
    assert got.shape == (N, 80)
    assert _rel(got, want) < 1e-6


def test_plain_matches_flat_writer_interpret_bf16(rng):
    feats, pos, batch = _inputs(rng)
    fb = [torch.from_numpy(f).to(torch.bfloat16) for f in feats]
    got = upsample_rows(fb, torch.from_numpy(pos), torch.from_numpy(batch),
                        WF, HF)
    assert got.dtype == torch.bfloat16
    want = upsample_flat_lookup([jnp.asarray(f, jnp.bfloat16) for f in feats],
                                jnp.asarray(pos), jnp.asarray(batch),
                                jnp.ones(N, bool), WF, HF, by=24,
                                interpret=True)
    assert _rel(got.float(), want) < 2e-2


def test_pixel_rounding_is_half_to_even():
    """A position exactly half-way between two pixels rounds to the even
    one in both frameworks (jnp.round and torch.round)."""
    feats = [np.arange(B * 4 * 8 * 1, dtype=np.float32).reshape(B, 4, 8, 1)]
    pos = np.array([[2.5 / 8, 1.5 / 4, 0], [3.5 / 8, 0.5 / 4, 0]],
                   np.float32)
    batch = np.zeros(2, np.int32)
    got = upsample_rows_plain([torch.from_numpy(feats[0])],
                              torch.from_numpy(pos), torch.from_numpy(batch),
                              8, 4)
    want = jlookup([jnp.asarray(feats[0])], jnp.asarray(pos),
                   jnp.asarray(batch), jnp.ones(2, bool), 8, 4,
                   mask_rows=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # (2.5, 1.5) -> pixel (2, 2); (3.5, 0.5) -> pixel (4, 0)
    np.testing.assert_array_equal(got[:, 0].numpy(), [2 * 8 + 2, 4])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_image_features_matches(rng, dtype):
    feat = rng.randn(B, 6, 9, 32).astype(np.float32)
    pos = rng.rand(500, 3).astype(np.float32)
    pos[:5, :2] = [[0, 0], [0.9999, 0.9999], [1.0, 1.0], [0.5, 0], [0, 1]]
    batch = rng.randint(0, B, 500).astype(np.int32)
    mask = rng.rand(500) > 0.2
    tdt = getattr(torch, dtype)
    got = sample_image_features(torch.from_numpy(feat).to(tdt),
                                torch.from_numpy(pos),
                                torch.from_numpy(batch),
                                torch.from_numpy(mask), 90, 60)
    want = jsample(jnp.asarray(feat, getattr(jnp, dtype)), jnp.asarray(pos),
                   jnp.asarray(batch), jnp.asarray(mask), 90, 60)
    assert _rel(got.float(), want) < (1e-6 if dtype == "float32" else 2e-2)


def test_cuda_wrapper_refuses_cpu_tensors(rng):
    feats, pos, batch = _inputs(rng)
    with pytest.raises(ValueError, match="CUDA"):
        upsample_rows_cuda([torch.from_numpy(f).bfloat16() for f in feats],
                           torch.from_numpy(pos), torch.from_numpy(batch),
                           WF, HF)


# (full size, map size): the operating point's 360 x 240 to maps 0 and 1,
# the fixture's 96 x 72, and sizes of 1
TAP_SIZES = [(360, 45), (240, 30), (360, 90), (240, 60), (96, 12), (72, 9),
             (96, 48), (1, 1), (1, 7), (9, 1), (5, 5)]


@pytest.mark.parametrize("full,size", TAP_SIZES)
def test_axis_taps_equal_jax_taps_bit_for_bit(full, size):
    """K4's per-axis tables (the kernel's ``(i0, i1, t)`` records, from the
    port's one copy of the taps, ``models/graph.axis_taps``) equal the
    Pallas writer's ``_taps`` and ``_interp_matrix`` of the JAX package
    bit for bit: the same source pixels, ``t`` the same f32 and ``1 - t``
    its ``w0``; the port's ``_interp_matrix``, built from them, equals the
    JAX package's."""
    i0, i1, t = axis_taps(full, size)
    j0, j1, w0, w1 = _taps(full, size)
    np.testing.assert_array_equal(i0, j0)
    np.testing.assert_array_equal(i1, j1)
    assert t.dtype == w1.dtype == np.float32
    np.testing.assert_array_equal(t.view(np.int32), w1.view(np.int32))
    np.testing.assert_array_equal((1 - t).view(np.int32), w0.view(np.int32))
    want = _interp_matrix(full, size)
    np.testing.assert_array_equal(tinterp(full, size).view(np.int32),
                                  want.view(np.int32))
    tab = tap_tables(full, 3, ((1, size),), "cpu")
    assert tab.dtype == torch.int32 and tab.shape == (1, full + 3, 4)
    np.testing.assert_array_equal(tab[0, :full, 0].numpy(), i0)
    np.testing.assert_array_equal(tab[0, :full, 1].numpy(), i1)
    np.testing.assert_array_equal(tab[0, :full, 2].numpy(), t.view(np.int32))


def test_tap_tables_are_made_once_per_geometry():
    sizes = ((45, 30), (90, 60))
    tab = tap_tables(360, 240, sizes, "cpu")
    assert tap_tables(360, 240, sizes, "cpu") is tab
    assert tab.shape == (2, 600, 4)
    assert tap_tables(360, 240, ((30, 45), (90, 60)), "cpu") is not tab


@pytest.mark.parametrize("shapes", [((9, 12, 16), (4, 6, 64)),
                                    ((1, 1, 3), (5, 7, 5)),
                                    ((72, 96, 8),)])
def test_plain_from_tables_matches_upsample_lookup_bf16(rng, shapes):
    """The plain K4 from the tap tables (f32 sums, one bf16 rounding) holds
    against the port's and the JAX package's ``upsample_lookup`` (two
    bf16 contractions) within the bf16 band, for maps of size 1, a C that
    is no multiple of 8 (the kernel's scalar path), and a map of the
    sensor's own size; with f32 maps it equals them to f32 rounding."""
    feats, pos, batch = _inputs(rng, shapes)
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-6)):
        tf = [torch.from_numpy(f).to(dtype) for f in feats]
        got = upsample_rows_plain(tf, torch.from_numpy(pos),
                                  torch.from_numpy(batch), WF, HF)
        assert got.dtype == dtype
        assert got.shape == (N, sum(c for _, _, c in shapes))
        port = upsample_lookup(tf, torch.from_numpy(pos),
                               torch.from_numpy(batch), None, WF, HF,
                               mask_rows=False)
        jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
        want = jlookup([jnp.asarray(f, jdt) for f in feats],
                       jnp.asarray(pos), jnp.asarray(batch),
                       jnp.ones(N, bool), WF, HF, mask_rows=False)
        assert _rel(got.float(), port.float()) < tol
        assert _rel(got.float(), np.asarray(want, np.float32)) < tol
