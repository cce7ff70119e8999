"""K1, the level-0 neighbour search: the port's plain version equals the
JAX package's XLA formulation, the numpy oracle and the Pallas kernel in
interpret mode, exactly (integer outputs, ties included).  The CUDA kernel
is held against this plain version on the card by ``chip_smoke.py``; here
a numpy mirror of the kernel's scan (its tiles, the running-max proof of
sorted times, the time cutoff, the packed keys) is held against the
contract."""
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


# ---------------------------------------------------------------------------
# the CUDA kernel's scan, re-stated in numpy
# ---------------------------------------------------------------------------
TILE = 128       # destinations a block of csrc/event_graph_search.cu
INT_MIN = -2**31


def _kernel_mirror(pos, valid, ranks, *, radius, delta_t_us, max_neighbors,
                   max_queue_size, lookback):
    """What ``csrc/event_graph_search.cu`` computes, step for step, over
    the destinations of an item at once: per tile of ``TILE`` destinations
    the proof that valid times never fall below the running maximum of the
    valid times before them over the tile's window ``[i0 - lookback, i0 +
    TILE)`` and, proven, the window's floor (above the last valid row too
    old for the tile's earliest destination) and the cutoff at the first
    valid candidate too old; keys ``(spiral * Q + rank) << dbits | d``.
    Returns ``(nbr, mask, doff, proven)``, ``proven`` per (item, tile)."""
    b, n, _ = pos.shape
    ko, q = max_neighbors - 1, max_queue_size
    lookback = min(lookback, n)
    dbits, bits = teg.search_key_bits(radius, q, lookback)
    assert bits <= 64
    sent = np.uint64(2**64 - 1)
    nbr = np.zeros((b, n, ko + 1), np.int32)
    mask = np.zeros((b, n, ko + 1), bool)
    doff = np.zeros((b, n, ko + 1, 2), np.int32)
    proven = np.zeros((b, -(-n // TILE)), bool)
    for it in range(b):
        x, y, t = (pos[it, :, c].astype(np.int64) for c in range(3))
        v, rk = valid[it], ranks[it].astype(np.int64)
        ii = np.arange(n)
        jst = np.zeros(n, np.int64)
        cut = np.zeros(n, bool)
        for tile, i0 in enumerate(range(0, n, TILE)):
            hi, lo = min(n, i0 + TILE), max(0, i0 - lookback)
            if not v[i0:hi].any():
                continue
            tv = np.where(v[lo:hi], t[lo:hi], INT_MIN)
            before = np.concatenate([[INT_MIN],
                                     np.maximum.accumulate(tv)[:-1]])
            ok = not np.any(v[lo:hi] & (t[lo:hi] < before))
            floor = lo
            if ok:
                old = np.flatnonzero(v[lo:hi] & (t[lo:hi] < t[i0:hi][
                    v[i0:hi]].min() - delta_t_us))
                floor = lo + old.max() + 1 if old.size else lo
            proven[it, tile] = ok
            jst[i0:hi], cut[i0:hi] = floor, ok
        thr = t - delta_t_us
        jmin = np.maximum(ii - np.minimum(lookback, ii), jst)
        active = v.copy()
        keys = np.full((n, ko), sent)
        for d in range(1, lookback + 1):
            j = ii - d
            jc = np.maximum(j, 0)
            cand = active & (j >= jmin) & v[jc]
            old = cand & (t[jc] < thr)
            dx, dy = x[jc] - x, y[jc] - y
            ok = cand & ~old & (np.abs(dx) <= radius) & (np.abs(dy) <= radius) \
                & (rk[jc] >= 0) & (rk[jc] < q)
            spiral = teg.spiral_index(torch.from_numpy(dx),
                                      torch.from_numpy(dy)).numpy()
            key = (((spiral * q + rk[jc]).astype(np.uint64) << np.uint64(dbits))
                   | np.uint64(d))
            keys = np.sort(np.concatenate(
                [keys, np.where(ok, key, sent)[:, None]], 1), 1)[:, :ko]
            active &= ~(old & cut)
        found = keys != sent
        jn = ii[:, None] - (keys & np.uint64(2**dbits - 1)).astype(np.int64)
        jn = np.where(found, jn, 0)
        nbr[it, :, 0] = np.where(v, ii, 0)
        mask[it, :, 0] = v
        nbr[it, :, 1:] = jn
        mask[it, :, 1:] = found
        for c, coord in enumerate((x, y)):
            doff[it, :, 1:, c] = np.where(found, coord[:, None] - coord[jn], 0)
    return nbr, mask, doff, proven


def _mirror_case(rng, case):
    """Two items of 1024 events in the fixture geometry, one changed by
    ``case``; returns ``(pos, valid, tiles the proof must fail, tiles it
    must hold)``, each a list of ``(item, tile)``."""
    pos, valid = _fixture_events(rng, n=1024)
    bad, good = [], [(1, 3), (1, 7)]
    if case == "unsorted":
        perm = rng.permutation(1024)
        pos[0] = pos[0, perm]
        bad = [(0, 0), (0, 5)]
    elif case == "interior_invalid":
        # event 300 invalid between two valid ones whose times fall
        k = 300
        valid[0, k] = False
        pos[0, k, 2] = pos[0, k - 1, 2]
        pos[0, k + 1, 2] = pos[0, k - 1, 2] - 50_000
        bad = [(0, k // TILE)]
        good.append((0, 0))
    elif case == "zero_time_tail":
        pos, valid = _fixture_events(rng, n=1024, n_valid=[300, 1024])
        good.append((0, 1))
    return pos, valid, bad, good


@pytest.mark.parametrize("case", ["sorted", "unsorted", "interior_invalid",
                                  "zero_time_tail"])
def test_kernel_mirror_matches_contract(rng, case):
    """The kernel's scan, mirrored in numpy, equals the XLA formulation at
    a lookback of 256 (tiles whose windows start above 0) and the numpy
    oracle at a lookback that covers the item, exactly; the proof holds
    and fails where the input says it must."""
    pos, valid, bad, good = _mirror_case(rng, case)
    ranks = teg._ranks_or_default(torch.from_numpy(pos),
                                  torch.from_numpy(valid), None).numpy()
    kw = dict(KW, max_neighbors=9)
    got = _kernel_mirror(pos, valid, ranks, lookback=256, **kw)
    want = jeg.build_graph(jnp.asarray(pos), jnp.asarray(valid),
                           lookback=256, **kw)
    _assert_same(got[:3], want)
    assert got[1][:, :, 1:].sum() > 100
    full = _kernel_mirror(pos, valid, ranks, lookback=1024, **kw)
    for it in range(2):
        nv = int(valid[it].sum()) if case == "zero_time_tail" else 1024
        ref = jeg.build_graph_numpy(pos[it, :nv], valid[it, :nv], **kw)
        _assert_same([g[it, :nv] for g in full[:3]], ref)
    for proven in (got[3], full[3]):
        assert all(not proven[t] for t in bad), proven
        assert all(proven[t] for t in good), proven
