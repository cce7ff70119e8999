"""K6a / K6b plain versions (``eventad_tpu_torch/ops/gather_window.py``)
against the JAX package on the same numpy inputs: the XLA formulation and
the Pallas kernels in interpret mode.  On the CPU the port's dispatchers run
the plain versions; the CUDA kernels are held against them on the card by
``chip_smoke.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventad_tpu.ops.gather_window import (_gather_window_diff,
                                           gather_window_rows as jax_gather,
                                           scatter_window_rows as jax_scatter)
from eventad_tpu_torch.ops import gather_window as gw

import _torch_threads  # noqa: F401  (one intra-op thread)


def _case(rng, n, k, c, lookback, tail=0):
    """Window-local neighbour table honouring the event-graph contract;
    masked slots hold -1 or an out-of-window index, and the last ``tail``
    rows are an under-filled (fully masked) tail."""
    src = rng.randn(n, c).astype(np.float32)
    nbr = np.zeros((n, k), np.int32)
    mask = rng.rand(n, k) > 0.3
    for i in range(n):
        nbr[i] = rng.randint(max(0, i - lookback), i + 1, k)
    mask[0] = False
    if tail:
        mask[n - tail:] = False
    junk = np.where(rng.rand(n, k) > 0.5, -1, n + 7).astype(np.int32)
    return src, np.where(mask, nbr, junk), mask


# (n, k, c, lookback, under-filled tail): n not a multiple of the Pallas
# block, lookback == n, and a fully masked tail
CASES = [(300, 15, 19, 128, 0), (333, 15, 16, 333, 0), (520, 4, 7, 260, 0),
         (300, 8, 10, 128, 90)]


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("n,k,c,lb,tail", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_equals_xla_formulation(rng, n, k, c, lb, tail, dtype):
    src, nbr, mask = _case(rng, n, k, c, lb, tail)
    jsrc = jnp.asarray(src).astype(dtype)
    safe = jnp.asarray(np.where(mask, nbr, 0))
    want = jnp.where(jnp.asarray(mask)[..., None], jsrc[safe], 0)
    tsrc, tnbr, tmask = _torch(src, nbr, mask)
    tsrc = tsrc.to(getattr(torch, dtype))
    for fn in (lambda: gw.gather_window_rows_plain(tsrc, tnbr, tmask),
               lambda: gw.gather_rows_auto(tsrc, tnbr, tmask, lookback=lb)):
        got = fn()
        assert got.dtype == tsrc.dtype and got.shape == (n, k, c)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    assert (got[~tmask] == 0).all()


@pytest.mark.parametrize("n,k,c,lb,tail", CASES)
@pytest.mark.parametrize("parts,rtol", [(3, 0.0), (2, 2.0 ** -16)])
def test_gather_equals_pallas_interpret(rng, n, k, c, lb, tail, parts, rtol):
    src, nbr, mask = _case(rng, n, k, c, lb, tail)
    want = np.asarray(jax_gather(jnp.asarray(src), jnp.asarray(nbr),
                                 jnp.asarray(mask), lookback=lb, parts=parts,
                                 interpret=True))
    got = gw.gather_window_rows(*_torch(src, nbr, mask), lookback=lb).numpy()
    if parts == 3:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(want, got, rtol=rtol, atol=0)


@pytest.mark.parametrize("n,k,c,lb,tail", CASES)
def test_scatter_matches_jax(rng, n, k, c, lb, tail):
    _, nbr, mask = _case(rng, n, k, c, lb, tail)
    g = rng.randn(n, k, c).astype(np.float32)
    got = gw.scatter_window_rows(*_torch(g, nbr, mask), n, lookback=lb)
    assert got.dtype == torch.float32 and got.shape == (n, c)
    safe = np.where(mask, nbr, 0)
    gm = jnp.where(jnp.asarray(mask)[..., None], jnp.asarray(g), 0.0)
    xla = jnp.zeros((n, c), jnp.float32).at[jnp.asarray(safe)].add(gm)
    pallas = jax_scatter(jnp.asarray(g), jnp.asarray(safe), jnp.asarray(mask),
                         n, parts=3, interpret=True)
    scale = np.abs(np.asarray(xla)).max()
    for want in (xla, pallas):
        assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6 * scale


def test_scatter_bf16_cotangent(rng):
    """A bf16 cotangent sums in f32 and returns bf16
    (gather_window.py:361-367)."""
    n, k, c, lb = 300, 8, 16, 128
    _, nbr, mask = _case(rng, n, k, c, lb)
    g = rng.randn(n, k, c).astype(np.float32)
    tg, tnbr, tmask = _torch(g, nbr, mask)
    tg = tg.to(torch.bfloat16)
    got = gw.scatter_window_rows(tg, tnbr, tmask, n, lookback=lb)
    assert got.dtype == torch.bfloat16
    want = gw.scatter_window_rows_plain(tg.float(), tnbr, tmask, n)
    torch.testing.assert_close(got.float(), want.to(torch.bfloat16).float(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("n,k,c,lb,tail", CASES[:2])
def test_gather_gradient_matches_jax_vjp(rng, n, k, c, lb, tail):
    """d sum(gather * r) / d src through ``GatherWindowRows`` (on the CPU
    its forward and backward are the plain versions) against ``jax.grad``
    through the custom VJP with the Pallas kernels in interpret mode, and
    against autograd through the plain gather."""
    src, nbr, mask = _case(rng, n, k, c, lb, tail)
    r = rng.randn(n, k, c).astype(np.float32)
    safe = jnp.asarray(np.where(mask, nbr, 0))
    want = np.asarray(jax.grad(lambda s: jnp.sum(_gather_window_diff(
        s, safe, jnp.asarray(mask), lb, True, 3) * jnp.asarray(r)))(
            jnp.asarray(src)))
    tsrc, tnbr, tmask, tr = _torch(src, nbr, mask, r)
    grads = []
    for fn in (lambda s: gw.gather_rows_auto(s, tnbr, tmask, lookback=lb),
               lambda s: gw.gather_window_rows_plain(s, tnbr, tmask)):
        s = tsrc.clone().requires_grad_(True)
        (fn(s) * tr).sum().backward()
        grads.append(s.grad.numpy())
    scale = np.abs(want).max()
    for got in grads:
        assert got.shape == src.shape
        assert np.abs(got - want).max() <= 1e-6 * scale


def test_cuda_wrappers_refuse_cpu_tensors(rng):
    """The kernel wrappers never give way to the plain version."""
    src, nbr, mask = _case(rng, 40, 4, 5, 16)
    args = _torch(src, nbr, mask)
    with pytest.raises(ValueError):
        gw.gather_window_rows_cuda(*args, lookback=16)
    with pytest.raises(ValueError):
        gw.scatter_window_rows_cuda(torch.zeros(40, 4, 5), args[1], args[2],
                                    40, lookback=16)
    assert gw.gather_window_rows_cuda.launches == 0
    assert gw.scatter_window_rows_cuda.launches == 0


def test_div_magic_equals_floor_division():
    """K6a finds each 16-byte word's first edge as ``(idx * m) >> s`` with
    ``(m, s) = div_magic(C)``; a numpy emulation of that multiply equals
    ``idx // C`` for every C in 1..256, at the largest index the 32-bit
    instantiation admits (2^31 - 1), around every multiple of C near 0, the
    middle and the top of that range, and at seeded random indices."""
    rs = np.random.RandomState(5)
    top = 2 ** 31 - 1
    rand = rs.randint(0, top, 4096, dtype=np.int64)
    for c in range(1, 257):
        m, s = gw.div_magic(c)
        assert 0 < m < 2 ** 32 and 31 <= s <= 39
        mults = np.concatenate([np.arange(0, 64), [top // c // 2],
                                np.arange(top // c - 63, top // c + 1)])
        idx = (mults[:, None] * c + np.array([-1, 0, 1])).ravel()
        idx = np.concatenate([idx, rand, [top]])
        idx = idx[(idx >= 0) & (idx <= top)].astype(np.uint64)
        got = (idx * np.uint64(m)) >> np.uint64(s)
        np.testing.assert_array_equal(got, idx // np.uint64(c), err_msg=c)
    with pytest.raises(ValueError):
        gw.div_magic(0)


def _word_walk(src, nbr, mask, kv):
    """numpy mirror of ``csrc/gather_window.cu``'s gather: each word of
    ``kv`` elements of the flat output finds its first (edge, channel) by
    ``div_magic``, then walks its elements, moving to the next edge where
    the channel reaches C; the mask is read before nbr; the tail word is
    short."""
    m_rows, k = nbr.shape
    c = src.shape[1]
    total = m_rows * k * c
    mg, s = gw.div_magic(c)
    flat_src, flat_nbr, flat_mask = src.ravel(), nbr.ravel(), mask.ravel()
    out = np.full(total, np.nan, src.dtype)
    for i0 in range(0, total, kv):
        e = (i0 * mg) >> s
        ch = i0 - e * c
        row = flat_nbr[e] * c if flat_mask[e] else None
        for j in range(min(kv, total - i0)):
            if ch == c:
                e, ch = e + 1, 0
                row = flat_nbr[e] * c if flat_mask[e] else None
            out[i0 + j] = 0 if row is None else flat_src[row + ch]
            ch += 1
    return out.reshape(m_rows, k, c)


@pytest.mark.parametrize("c", [1, 3, 16, 19])
@pytest.mark.parametrize("kv", [4, 8])
def test_word_walk_mirror_equals_plain(rng, c, kv):
    """The kernel's walk over 16-byte words (4 f32 or 8 bf16 values), with
    rows of C values that a word may span (two edges at C 19, several at C
    1 and 3) and a flat size that no word divides, gives the plain
    gather's values exactly."""
    src, nbr, mask = _case(rng, 37, 3, c, 16)
    got = _word_walk(src, nbr, mask, kv)
    want = gw.gather_window_rows_plain(*_torch(src, nbr, mask)).numpy()
    assert (37 * 3 * c) % kv or c == 16
    np.testing.assert_array_equal(got, want)


def _scatter_mirror(g, nbr, mask, n_src, lookback):
    """numpy mirror of ``csrc/gather_window.cu``'s scatter.  The listing
    pass: per block of ``LIST_EDGES`` flat edges its unmasked edges in edge
    order with their source.  The summing pass, per tile of
    ``scatter_tile(C)`` source rows: the lists of destinations [s0, s0 +
    rows + lookback) read as one sequence (``SCATTER_THREADS`` lists at a
    time), ``SCATTER_THREADS`` entries a window; in a window the entries
    that point into the tile are placed into per-row buckets as the kernel
    places them (rank among the same row's lanes of the warp, the row's
    counts in the warps before, the rows before), and each row adds its
    bucket in f32, in bucket order.  Asserts that the placement leaves no
    hole and hits no slot twice."""
    m, k, c = g.shape
    total, per = m * k, gw.LIST_EDGES
    threads, warps = gw.SCATTER_THREADS, gw.SCATTER_THREADS // 32
    flat_g = g.reshape(total, c)
    flat_mask, flat_nbr = mask.ravel(), nbr.ravel()
    n_lists = -(-total // per)
    lists = []
    for b in range(n_lists):
        es = np.flatnonzero(flat_mask[b * per:(b + 1) * per]) + b * per
        lists.append([(int(e), int(flat_nbr[e])) for e in es])
    tile = gw.scatter_tile(c)
    out = np.zeros((n_src, c), np.float32)
    for s0 in range(0, n_src, tile):
        rows = min(tile, n_src - s0)
        e_lo, e_hi = s0 * k, min(m, s0 + rows + lookback) * k
        acc = np.zeros((rows, c), np.float32)
        l0, l1 = e_lo // per, min(n_lists, -(-e_hi // per))
        for lc in range(l0, l1, threads):
            seq = sum(lists[lc:min(l1, lc + threads)], [])
            for w0 in range(0, len(seq), threads):
                kept = [(e, s - s0) if s0 <= s < s0 + rows
                        and e_lo <= e < e_hi else None
                        for e, s in seq[w0:w0 + threads]]
                hist = np.zeros((warps, rows), np.int64)
                rank = {}
                for t, kv in enumerate(kept):
                    if kv is not None:
                        w, r = t // 32, kv[1]
                        rank[t] = sum(1 for u in range(w * 32, t)
                                      if kept[u] is not None
                                      and kept[u][1] == r)
                        hist[w, r] += 1
                count = hist.sum(0)
                before = np.cumsum(hist, 0) - hist
                start = np.cumsum(count) - count
                bucket = np.full(len(kept), -1)
                for t, r0 in rank.items():
                    e, r = kept[t]
                    at = start[r] + before[t // 32, r] + r0
                    assert bucket[at] == -1
                    bucket[at] = e
                assert (bucket[:len(rank)] >= 0).all()
                for r in np.flatnonzero(count):
                    for e in bucket[start[r]:start[r] + count[r]]:
                        acc[r] += flat_g[e]
        out[s0:s0 + rows] = acc
    return out


def _scatter_graph(rng, n, k, lookback, share, kind):
    """A graph honouring ``i - lookback <= nbr <= i``: ``sparse`` / ``dense``
    random windows, ``edges`` only the window's two ends (``i - lookback``
    and ``i``), ``tail`` a fully masked last third (an under-filled item's
    t = 0 tail); masked slots hold -1 or an out-of-window index."""
    nbr = np.zeros((n, k), np.int32)
    for i in range(n):
        lo = max(0, i - lookback)
        nbr[i] = (np.where(rng.rand(k) < 0.5, lo, i) if kind == "edges"
                  else rng.randint(lo, i + 1, k))
    mask = rng.rand(n, k) < share
    if kind == "edges":
        mask &= (nbr == np.arange(n)[:, None] - lookback) \
            | (nbr == np.arange(n)[:, None])
    if kind == "tail":
        mask[n - n // 3:] = False
    junk = np.where(rng.rand(n, k) > 0.5, -1, n + 7).astype(np.int32)
    return np.where(mask, nbr, junk), mask


# (graph, n, k, c, lookback, share of slots that hold an edge): the
# operating point's 0.15 edges a row over several listing blocks, a dense
# graph whose windows put many entries of one row into one warp, the
# window's two ends, and a masked tail; C 19, 40 and 100 take source tiles
# of 256, 128 and 64 rows
SCATTER_GRAPHS = [("sparse", 3000, 15, 19, 1024, 0.01),
                  ("dense", 1200, 15, 19, 128, 0.85),
                  ("edges", 700, 8, 40, 100, 0.9),
                  ("tail", 900, 15, 100, 256, 0.5)]


@pytest.mark.parametrize("kind,n,k,c,lb,share", SCATTER_GRAPHS)
def test_scatter_mirror_equals_plain(rng, kind, n, k, c, lb, share):
    """The kernel's listing and bucketing, mirrored in numpy, sums every
    row in ascending edge order: the plain version's sequential
    ``index_add_`` bit for bit in f32."""
    nbr, mask = _scatter_graph(rng, n, k, lb, share, kind)
    g = rng.randn(n, k, c).astype(np.float32)
    got = _scatter_mirror(g, nbr, mask, n, lb)
    want = gw.scatter_window_rows_plain(*_torch(g, nbr, mask), n).numpy()
    assert mask.sum() > 0 and (want != 0).any()
    np.testing.assert_array_equal(got, want)
