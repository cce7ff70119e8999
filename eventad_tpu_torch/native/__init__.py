"""Host-side event helpers of the data layer (counterpart of
``eventad_tpu/native``): per-pixel queue ranks, the window slice + rebase of
one item, the keep-mask of the zoom-out subsample and the polarity-balanced
subsample.

Each runs the port's C++ (``evio.cpp``), built with ``g++`` at the first
call into ``eventad_tpu_torch/build/libevio_<digest>.so`` (named by a digest
of the source and the flags, so an edited source rebuilds; written through a
temporary file and ``os.replace``, so processes that build at once each load
a whole library) and loaded with ``ctypes``.  A failed build raises; nothing
falls back.  The numpy functions ``*_plain`` compute the same results the
plain way and are what the tests hold the C++ against.  Nothing here runs
at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "evio.cpp"
BUILD_DIR = _HERE.parent / "build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-ffp-contract=off")

_i64, _i32 = ctypes.c_int64, ctypes.c_int32
_LIB = None
_LOCK = threading.Lock()


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libevio_{h.hexdigest()[:16]}.so"


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))

    def arr(dt):
        return np.ctypeslib.ndpointer(dt, flags="C")
    i32p, i8p = arr(np.int32), arr(np.int8)
    lib.queue_ranks.restype = _i64
    lib.queue_ranks.argtypes = [i32p, i32p, _i64, _i32, _i32, i32p]
    lib.window_rebase.restype = _i64
    lib.window_rebase.argtypes = [
        arr(np.uint16), arr(np.uint16), arr(np.int64), arr(np.uint8), _i64,
        _i64, _i64, _i64, _i32, i32p, i32p, i32p, i8p, _i64]
    lib.subsample_balanced.restype = _i64
    lib.subsample_balanced.argtypes = [
        i32p, i32p, i32p, i8p, _i64, _i64, i32p, i32p, i32p, i8p]
    lib.zoom_subsample.restype = _i64
    lib.zoom_subsample.argtypes = [
        i32p, i32p, i8p, _i64, _i32, _i32, ctypes.c_float, arr(np.uint8)]
    return lib


def library() -> ctypes.CDLL:
    """Builds (once per digest) and loads the library; raises if ``g++``
    fails."""
    global _LIB
    if _LIB is not None:
        return _LIB
    with _LOCK:
        if _LIB is None:
            out = library_path()
            if not out.exists():
                BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = out.with_suffix(f".{os.getpid()}.tmp")
                res = subprocess.run(
                    ["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                    capture_output=True, text=True)
                if res.returncode != 0:
                    tmp.unlink(missing_ok=True)
                    raise RuntimeError(f"g++ failed ({res.returncode}) on "
                                       f"{SOURCE}:\n{res.stderr[-4000:]}")
                os.replace(tmp, out)
            _LIB = _load(out)
    return _LIB


def _exact(a, dtype, name: str) -> np.ndarray:
    """``a`` as a contiguous ``dtype`` array; raises if a value changes."""
    a = np.asarray(a)
    out = np.ascontiguousarray(a, dtype).reshape(-1)
    if a.dtype != out.dtype and not np.array_equal(out, a.reshape(-1)):
        raise ValueError(f"{name}: values of {a.dtype} do not fit {dtype}")
    return out


def _same_length(*arrays) -> int:
    n = len(arrays[0])
    if any(len(a) != n for a in arrays):
        raise ValueError(f"arrays of lengths {[len(a) for a in arrays]}")
    return n


def _out_of_frame(i: int, x, y, width: int, height: int):
    return ValueError(f"queue_ranks: event {i} at ({int(x[i])}, "
                      f"{int(y[i])}) lies outside the {width}x{height} frame")


# ---------------------------------------------------------------------------
# per-pixel queue ranks
# ---------------------------------------------------------------------------
def queue_ranks(x, y, width: int, height: int) -> np.ndarray:
    """Per-pixel recency rank: the number of later events at the same pixel
    (the slot of each event in the reference's per-pixel FIFO once the whole
    window is inserted, ev_graph.cu:169-212).  Every event must lie in the
    ``width`` x ``height`` frame."""
    x = _exact(x, np.int32, "x")
    y = _exact(y, np.int32, "y")
    n = _same_length(x, y)
    out = np.empty(n, np.int32)
    bad = library().queue_ranks(x, y, n, width, height, out)
    if bad >= 0:
        raise _out_of_frame(bad, x, y, width, height)
    return out


def queue_ranks_plain(x, y, width: int, height: int) -> np.ndarray:
    """Plain version of :func:`queue_ranks`: a stable sort by pixel, each
    rank counted from the end of its pixel's group."""
    x = np.asarray(x, np.int64)
    y = np.asarray(y, np.int64)
    n = _same_length(x, y)
    bad = np.nonzero((x < 0) | (x >= width) | (y < 0) | (y >= height))[0]
    if len(bad):
        raise _out_of_frame(bad[0], x, y, width, height)
    pix = y * width + x
    order = np.argsort(pix, kind="stable")
    sp = pix[order]
    pos = np.arange(n)
    is_last = np.concatenate([sp[1:] != sp[:-1], [True]])
    last_pos = np.where(is_last, pos, n)
    last_pos = np.minimum.accumulate(last_pos[::-1])[::-1]
    out = np.empty(n, np.int32)
    out[order] = (last_pos - pos).astype(np.int32)
    return out


# ---------------------------------------------------------------------------
# window slice + rebase
# ---------------------------------------------------------------------------
def _raw(events: dict):
    """The stored columns: x, y uint16, t int64 (sorted), p uint8."""
    cols = (_exact(events["x"], np.uint16, "x"),
            _exact(events["y"], np.uint16, "y"),
            _exact(events["t"], np.int64, "t"),
            _exact(events["p"], np.uint8, "p"))
    _same_length(*cols)
    return cols


def window_rebase(events: dict, t0: int, t1: int, time_window: int,
                  height: int) -> dict:
    """The events with ``t0 <= t < t1`` (``t`` sorted) and ``y < height``,
    their times rebased so the window ends at ``time_window``, polarity
    mapped to +-1 (preprocess_events, dsec_data.py:124-130).  ``events``:
    x, y, t, p as stored (uint16, uint16, int64, uint8)."""
    x, y, t, p = _raw(events)
    n = len(t)
    ox, oy, ot = (np.empty(n, np.int32) for _ in range(3))
    op = np.empty(n, np.int8)
    m = library().window_rebase(x, y, t, p, n, t0, t1, time_window, height,
                                ox, oy, ot, op, n)
    return dict(x=ox[:m], y=oy[:m], t=ot[:m], p=op[:m])


def window_rebase_plain(events: dict, t0: int, t1: int, time_window: int,
                        height: int) -> dict:
    """Plain version of :func:`window_rebase`."""
    x, y, t, p = _raw(events)
    i0, i1 = np.searchsorted(t, (t0, t1))
    keep = y[i0:i1] < height
    tt = t[i0:i1][keep]
    if len(tt):
        tt = time_window + tt - tt[-1]
    return dict(x=x[i0:i1][keep].astype(np.int32),
                y=y[i0:i1][keep].astype(np.int32),
                t=tt.astype(np.int32),
                p=(2 * p[i0:i1][keep].astype(np.int32) - 1).astype(np.int8))


# ---------------------------------------------------------------------------
# zoom-out subsample
# ---------------------------------------------------------------------------
def _zoom_inputs(x, y, p):
    x = _exact(x, np.int32, "x")
    y = _exact(y, np.int32, "y")
    p = _exact(p, np.int8, "p")
    _same_length(x, y, p)
    return x, y, p


def zoom_subsample_mask(x, y, p, width: int, height: int,
                        threshold: float) -> np.ndarray:
    """Keep-mask of the reference's density-preserving zoom-out subsample
    (augment.py:13-37 on integer positions): a signed polarity counter per
    cell of a (height+1, width+1) grid, in f32; an event is kept when its
    cell's counter crosses +-threshold, which then moves back by it.
    Events outside the grid are dropped."""
    x, y, p = _zoom_inputs(x, y, p)
    keep = np.empty(len(x), np.uint8)
    library().zoom_subsample(x, y, p, len(x), width, height,
                             float(threshold), keep)
    return keep.astype(bool)


def zoom_subsample_mask_plain(x, y, p, width: int, height: int,
                              threshold: float) -> np.ndarray:
    """Plain version of :func:`zoom_subsample_mask`.  Cells are independent
    and each is sequential in event order, so the r-th events of all cells
    are processed together, r = 0, 1, ...: the same f32 operations per cell
    in the same order as one loop over the events."""
    x, y, p = _zoom_inputs(x, y, p)
    x, y = x.astype(np.int64), y.astype(np.int64)
    pol_in = p.astype(np.float32)
    keep = np.zeros(len(x), bool)
    idx = np.nonzero((x >= 0) & (x <= width) & (y >= 0) & (y <= height))[0]
    if not len(idx):
        return keep
    cell = y[idx] * (width + 1) + x[idx]
    order = np.argsort(cell, kind="stable")
    idx, cell = idx[order], cell[order]
    start = np.concatenate([[True], cell[1:] != cell[:-1]])
    pos = np.arange(len(cell))
    rank = pos - np.maximum.accumulate(np.where(start, pos, 0))
    group = np.cumsum(start) - 1
    count = np.zeros(int(group[-1]) + 1, np.float32)
    thr = np.float32(threshold)
    by_rank = np.argsort(rank, kind="stable")
    bounds = np.searchsorted(rank[by_rank], np.arange(int(rank.max()) + 2))
    one = np.float32(1)
    for r in range(int(rank.max()) + 1):
        sel = by_rank[bounds[r]:bounds[r + 1]]
        g = group[sel]
        c = count[g] + pol_in[idx[sel]]
        pol = np.where(c > 0, one, -one)
        fire = pol * c > thr
        count[g] = np.where(fire, c - pol * thr, c)
        keep[idx[sel][fire]] = True
    return keep


# ---------------------------------------------------------------------------
# polarity-balanced subsample
# ---------------------------------------------------------------------------
def _events_i32(events: dict):
    cols = (_exact(events["x"], np.int32, "x"),
            _exact(events["y"], np.int32, "y"),
            _exact(events["t"], np.int32, "t"),
            _exact(events["p"], np.int8, "p"))
    _same_length(*cols)
    return cols


def subsample_balanced(events: dict, target: int) -> dict:
    """At most ``target`` events of ``events`` (x, y, t int32, p int8 +-1),
    in stream order and balanced by polarity: per polarity a rate
    accumulator keeps an event each time it reaches 1; positive events are
    wanted up to ``target // 2`` plus what the negative ones cannot fill."""
    x, y, t, p = _events_i32(events)
    n = len(t)
    ox, oy, ot = (np.empty(n, np.int32) for _ in range(3))
    op = np.empty(n, np.int8)
    m = library().subsample_balanced(x, y, t, p, n, target, ox, oy, ot, op)
    return dict(x=ox[:m], y=oy[:m], t=ot[:m], p=op[:m])


def subsample_balanced_plain(events: dict, target: int) -> dict:
    """Plain version of :func:`subsample_balanced`, one event at a time
    with the same double-precision accumulators."""
    x, y, t, p = _events_i32(events)
    n = len(t)
    if n <= target:
        return dict(x=x.copy(), y=y.copy(), t=t.copy(), p=p.copy())
    pos = p > 0
    n_pos = int(pos.sum())
    n_neg = n - n_pos
    want_pos = min(n_pos, target // 2 + max(0, target // 2 - n_neg))
    want_neg = min(n_neg, target - want_pos)
    rate = {True: want_pos / n_pos if n_pos else 0.0,
            False: want_neg / n_neg if n_neg else 0.0}
    acc = {True: 0.0, False: 0.0}
    kept = []
    for i in range(n):
        if len(kept) >= target:
            break
        s = bool(pos[i])
        acc[s] += rate[s]
        if acc[s] >= 1.0:
            acc[s] -= 1.0
            kept.append(i)
    kept = np.asarray(kept, np.int64)
    return dict(x=x[kept], y=y[kept], t=t[kept], p=p[kept])
