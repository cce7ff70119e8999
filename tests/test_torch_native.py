"""The port's C++ host loops (``eventad_tpu_torch/native/evio.cpp``) against
their numpy plain versions and the JAX package's native library, bit for
bit, on numpy-seeded inputs: empty input, events out of frame, pile-ups on
one pixel, and zoom thresholds whose counters cross many times."""
import numpy as np
import pytest

from eventad_tpu import native as jax_native
from eventad_tpu_torch import native

W, H = 40, 30


@pytest.fixture(scope="module", autouse=True)
def both_libraries():
    # the JAX package's C++, not its numpy fallbacks (subsample_balanced's
    # fallback computes another subsample)
    assert jax_native.get_lib() is not None
    native.library()


def _equal_dicts(*outs):
    for o in outs[1:]:
        assert o.keys() == outs[0].keys()
        for k in o:
            assert o[k].dtype == outs[0][k].dtype, k
            np.testing.assert_array_equal(o[k], outs[0][k], err_msg=k)


def _pixels(kind, rng, n):
    if kind == "uniform":
        return rng.randint(0, W, n), rng.randint(0, H, n)
    if kind == "pileup":        # most events on one pixel, the rest on four
        x = np.where(rng.rand(n) < 0.7, 7, rng.randint(0, 2, n))
        y = np.where(x == 7, 3, rng.randint(0, 2, n))
        return x, y
    return np.zeros(0, int), np.zeros(0, int)      # empty


# ---------------------------------------------------------------------------
# queue ranks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,n", [("uniform", 5000), ("uniform", 1),
                                    ("pileup", 3000), ("empty", 0)])
def test_queue_ranks(kind, n):
    rng = np.random.RandomState(n)
    x, y = (a.astype(np.int32) for a in _pixels(kind, rng, n))
    got = native.queue_ranks(x, y, W, H)
    assert got.dtype == np.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got, native.queue_ranks_plain(x, y, W, H))
    np.testing.assert_array_equal(got, jax_native.queue_ranks(x, y, W, H))
    if kind == "pileup":
        assert got.max() > n // 2


@pytest.mark.parametrize("fn", [native.queue_ranks, native.queue_ranks_plain])
@pytest.mark.parametrize("x,y", [(W, 0), (-1, 3), (2, H), (0, -5)])
def test_queue_ranks_refuse_events_out_of_frame(fn, x, y):
    """Every caller passes events inside the frame; the counter table has
    no cell for one outside, so both versions raise, naming the event."""
    xs = np.array([1, 2, x, 3], np.int32)
    ys = np.array([1, 2, y, 3], np.int32)
    with pytest.raises(ValueError, match="event 2 at"):
        fn(xs, ys, W, H)


def test_queue_ranks_refuse_values_that_do_not_fit():
    with pytest.raises(ValueError, match="do not fit"):
        native.queue_ranks(np.array([2**40]), np.array([0]), W, H)


# ---------------------------------------------------------------------------
# window slice + rebase
# ---------------------------------------------------------------------------
def _raw_events(rng, n, y_hi=H + 5):
    return dict(x=rng.randint(0, W, n).astype(np.uint16),
                y=rng.randint(0, y_hi, n).astype(np.uint16),
                t=np.sort(rng.randint(0, 100_000, n)).astype(np.int64),
                p=rng.randint(0, 2, n).astype(np.uint8))


@pytest.mark.parametrize("n,t0,t1", [(4000, 20_000, 70_000),
                                     (4000, -5, 200_000),
                                     (4000, 50_000, 50_000),
                                     (4000, 150_000, 160_000),
                                     (0, 0, 10)])
def test_window_rebase(n, t0, t1):
    """Events with y >= H (out of frame) among them are dropped, and the
    rebase is against the last kept event; an empty window gives empty
    columns."""
    ev = _raw_events(np.random.RandomState(n + t0), n)
    got = native.window_rebase(ev, t0, t1, 50_000, H)
    _equal_dicts(got, native.window_rebase_plain(ev, t0, t1, 50_000, H),
                 jax_native.window_rebase(ev, t0, t1, 50_000, H))
    if len(got["t"]):
        assert got["t"][-1] == 50_000 and (got["y"] < H).all()
        assert set(np.unique(got["p"])) <= {-1, 1}


def test_window_rebase_every_event_out_of_frame():
    ev = _raw_events(np.random.RandomState(3), 500)
    ev["y"][:] = H + 1
    got = native.window_rebase(ev, 0, 200_000, 50_000, H)
    assert all(len(v) == 0 for v in got.values())
    _equal_dicts(got, native.window_rebase_plain(ev, 0, 200_000, 50_000, H),
                 jax_native.window_rebase(ev, 0, 200_000, 50_000, H))


# ---------------------------------------------------------------------------
# zoom-out subsample
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind,n,thr", [
    ("uniform", 4000, 1 / 0.7 ** 2),
    ("uniform", 4000, 1.0000001),   # a crossing on almost every event
    ("pileup", 6000, 1 / 0.9 ** 2),  # one cell's counter crosses ~thousands
    ("pileup", 6000, 3.3),
    ("out_of_frame", 3000, 1 / 0.6 ** 2),
    ("empty", 0, 2.0)])
def test_zoom_subsample_mask(kind, n, thr):
    rng = np.random.RandomState(n)
    if kind == "out_of_frame":
        x = rng.randint(-4, W + 5, n)
        y = rng.randint(-4, H + 5, n)
    else:
        x, y = _pixels(kind, rng, n)
    x, y = x.astype(np.int32), y.astype(np.int32)
    # runs of one polarity, so a cell's counter swings both ways
    p = np.repeat(rng.choice([-1, 1], n // 8 + 1), 8)[:n].astype(np.int8)
    got = native.zoom_subsample_mask(x, y, p, W, H, thr)
    assert got.dtype == bool and got.shape == (n,)
    np.testing.assert_array_equal(
        got, native.zoom_subsample_mask_plain(x, y, p, W, H, thr))
    np.testing.assert_array_equal(
        got, jax_native.zoom_subsample_mask(x, y, p, W, H, thr))
    if kind == "out_of_frame":
        outside = (x < 0) | (x > W) | (y < 0) | (y > H)
        assert outside.any() and not got[outside].any()
    if kind == "pileup":
        assert got.sum() > 100


# ---------------------------------------------------------------------------
# polarity-balanced subsample
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,target,pos_share", [
    (5000, 1000, 0.5), (5000, 1000, 0.95), (5000, 4999, 0.3),
    (5000, 1000, 1.0), (5000, 1000, 0.0), (300, 1000, 0.5), (0, 10, 0.5)])
def test_subsample_balanced(n, target, pos_share):
    """Against the JAX package's C++ (its numpy fallback, a ``linspace``
    stride, is another function)."""
    rng = np.random.RandomState(target + n)
    ev = dict(x=rng.randint(0, W, n).astype(np.int32),
              y=rng.randint(0, H, n).astype(np.int32),
              t=np.sort(rng.randint(0, 50_000, n)).astype(np.int32),
              p=np.where(rng.rand(n) < pos_share, 1, -1).astype(np.int8))
    got = native.subsample_balanced(ev, target)
    _equal_dicts(got, native.subsample_balanced_plain(ev, target))
    if n > target:
        lib_out = jax_native.subsample_balanced(ev, target)
        _equal_dicts(got, lib_out)
        assert 0.9 * target <= len(got["t"]) <= target
        assert (np.diff(got["t"]) >= 0).all()
    else:
        _equal_dicts(got, ev)


def test_library_is_named_by_its_digest_and_built_in_the_port():
    path = native.library_path()
    assert path.parent == native.BUILD_DIR
    assert path.parent.parent.name == "eventad_tpu_torch"
    assert path.exists() and "-ffp-contract=off" in native.CXX_FLAGS


def test_library_builds_once_under_concurrent_first_calls(monkeypatch,
                                                          tmp_path):
    """Threads that make the first call at once share one build; the
    library lands whole under its digest name, no temporary file left."""
    import threading
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "_LIB", None)
    libs = []
    threads = [threading.Thread(target=lambda: libs.append(native.library()))
               for _ in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    assert len(libs) == 6 and all(lib is libs[0] for lib in libs)
    assert [p.name for p in tmp_path.iterdir()] == [
        native.library_path().name]
