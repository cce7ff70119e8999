"""K1, the level-0 neighbour search: the port's plain version equals the
JAX package's XLA formulation, the numpy oracle and the Pallas kernel in
interpret mode, exactly (integer outputs, ties included).  The CUDA kernel
is held against this plain version on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventad_tpu.ops import event_graph as jeg
from eventad_tpu.ops.event_graph_pallas import build_graph_pallas
from eventad_tpu_torch.ops import event_graph as teg

import _torch_threads  # noqa: F401  (one intra-op thread)

# fixture geometry: 96x72, radius 2 px, 10 ms, K 16, Q 128
KW = dict(radius=2, delta_t_us=10_000, max_neighbors=16, max_queue_size=128)


def _fixture_events(rng, b=2, n=4096, n_valid=None, w=96, h=72):
    pos = np.zeros((b, n, 3), np.int32)
    valid = np.zeros((b, n), bool)
    for i in range(b):
        nv = n if n_valid is None else n_valid[i]
        pos[i, :nv, 0] = rng.randint(0, w, nv)
        pos[i, :nv, 1] = rng.randint(0, h, nv)
        pos[i, :nv, 2] = np.sort(rng.randint(0, 200_000, nv))
        valid[i, :nv] = True
    return pos, valid


def _torch(pos, valid, ranks=None, **kw):
    r = None if ranks is None else torch.from_numpy(np.asarray(ranks))
    out = teg.build_graph(torch.from_numpy(pos), torch.from_numpy(valid), r,
                          **kw)
    return tuple(o.numpy() for o in out)


def _assert_same(got, want):
    for g, w, name in zip(got, want, ("nbr", "nbr_mask", "doff")):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


def test_matches_xla_formulation_full_bucket(rng):
    pos, valid = _fixture_events(rng)
    got = _torch(pos, valid, lookback=512, **KW)
    want = jeg.build_graph(jnp.asarray(pos), jnp.asarray(valid),
                           lookback=512, **KW)
    _assert_same(got, want)
    assert got[1][:, :, 1:].sum() > 1000       # a non-trivial graph


def test_matches_numpy_oracle_and_host_ranks(rng):
    """Dense pixels (many ties of the spiral key within a pixel queue) with
    host-computed ranks; lookback covers the item, as the oracle has none."""
    from eventad_tpu import native
    pos, valid = _fixture_events(rng, b=1, n=600, w=6, h=5)
    pos[..., 2] //= 50
    kw = dict(radius=2, delta_t_us=1_000, max_neighbors=9, max_queue_size=8)
    ranks = native.queue_ranks(pos[0, :, 0], pos[0, :, 1], 6, 5)[None]
    got = _torch(pos, valid, ranks, lookback=600, **kw)
    want = jeg.build_graph_numpy(pos[0], valid[0], **kw)
    _assert_same([g[0] for g in got], want)


def test_matches_pallas_interpret_full_bucket(rng):
    pos, valid = _fixture_events(rng, b=1, n=1024)
    got = _torch(pos, valid, lookback=512, **KW)
    want = build_graph_pallas(jnp.asarray(pos), jnp.asarray(valid),
                              lookback=512, chunk=128, grid_wh=(96, 72),
                              interpret=True, **KW)
    _assert_same(got, want)


def test_underfilled_bucket_zero_time_tail(rng):
    """Items filling part of their bucket, the padding tail at t = 0: the
    port follows the XLA / numpy contract (the TPU kernel's per-chunk time
    bound does not, ROADMAP F1)."""
    pos, valid = _fixture_events(rng, n=2048, n_valid=[700, 2048])
    got = _torch(pos, valid, lookback=512, **KW)
    want = jeg.build_graph(jnp.asarray(pos), jnp.asarray(valid),
                           lookback=512, **KW)
    _assert_same(got, want)
    assert not got[1][0, 700:].any()
    ref = jeg.build_graph_numpy(pos[0, :700], valid[0, :700], **KW)
    _assert_same([g[0, :700] for g in got], ref)


def test_spiral_index_offset_and_queue_rank(rng):
    r = 6
    table = teg.spiral_index_table(r)
    np.testing.assert_array_equal(table, jeg.spiral_index_table(r))
    dy, dx = np.meshgrid(np.arange(-r, r + 1), np.arange(-r, r + 1),
                         indexing="ij")
    s = teg.spiral_index(torch.from_numpy(dx), torch.from_numpy(dy))
    np.testing.assert_array_equal(s.numpy(), table)
    ox, oy = teg.spiral_offset(s)
    np.testing.assert_array_equal(ox.numpy(), dx)
    np.testing.assert_array_equal(oy.numpy(), dy)
    pix = rng.randint(0, 40, 2000).astype(np.int32)
    valid = rng.rand(2000) > 0.1
    got = teg.queue_rank(torch.from_numpy(pix), torch.from_numpy(valid))
    want = jeg.queue_rank(jnp.asarray(pix), jnp.asarray(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_dispatch_by_device_and_wrapper_checks(rng):
    """A CPU tensor goes to the plain version; the kernel wrapper refuses
    what it does not take (here: a CPU tensor) before any launch."""
    pos, valid = _fixture_events(rng, b=1, n=300)
    p, v = torch.from_numpy(pos), torch.from_numpy(valid)
    auto = teg.build_graph_auto(p, v, radius=2, delta_t_us=10_000,
                                lookback=128)
    plain = teg.build_graph(p, v, radius=2, delta_t_us=10_000, lookback=128)
    for a, b in zip(auto, plain):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        teg.build_graph_cuda(p, v, radius=2, delta_t_us=10_000)
    with pytest.raises(ValueError, match="max_neighbors"):
        teg.build_graph_cuda(p, v, radius=2, delta_t_us=10_000,
                             max_neighbors=40)
