"""Host-side event helpers of the data layer, in numpy (counterpart of
``eventad_tpu/native/__init__.py``'s numpy paths): per-pixel queue ranks,
the window slice + rebase of one item, and the keep-mask of the zoom-out
subsample.  The JAX package also builds a C++ copy of these; the port has
none until a measurement shows that one pays (``chip_smoke.py`` phase 11
times ``collate``, where the queue ranks run)."""
from __future__ import annotations

import numpy as np


def queue_ranks(x: np.ndarray, y: np.ndarray, width: int,
                height: int) -> np.ndarray:
    """Per-pixel recency rank: the number of later events at the same pixel
    (the slot of each event in the reference's per-pixel FIFO once the whole
    window is inserted, ev_graph.cu:169-212)."""
    n = len(x)
    pix = np.asarray(y, np.int64) * width + np.asarray(x, np.int64)
    order = np.argsort(pix, kind="stable")
    sp = pix[order]
    pos = np.arange(n)
    is_last = np.concatenate([sp[1:] != sp[:-1], [True]])
    last_pos = np.where(is_last, pos, n)
    last_pos = np.minimum.accumulate(last_pos[::-1])[::-1]
    out = np.empty(n, np.int32)
    out[order] = (last_pos - pos).astype(np.int32)
    return out


def window_rebase(events: dict, t0: int, t1: int, time_window: int,
                  height: int) -> dict:
    """The events with ``t0 <= t < t1`` (``t`` sorted) and ``y < height``,
    their times rebased so the window ends at ``time_window``, polarity
    mapped to +-1 (preprocess_events, dsec_data.py:124-130)."""
    x = np.asarray(events["x"])
    y = np.asarray(events["y"])
    t = np.asarray(events["t"], np.int64)
    p = np.asarray(events["p"])
    i0, i1 = np.searchsorted(t, (t0, t1))
    keep = y[i0:i1] < height
    tt = t[i0:i1][keep]
    if len(tt):
        tt = time_window + tt - tt[-1]
    return dict(x=x[i0:i1][keep].astype(np.int32),
                y=y[i0:i1][keep].astype(np.int32),
                t=tt.astype(np.int32),
                p=(2 * p[i0:i1][keep].astype(np.int32) - 1).astype(np.int8))


def zoom_subsample_mask(x: np.ndarray, y: np.ndarray, p: np.ndarray,
                        width: int, height: int,
                        threshold: float) -> np.ndarray:
    """Keep-mask of the reference's density-preserving zoom-out subsample
    (augment.py:13-37 on integer positions): a signed polarity counter per
    cell of a (height+1, width+1) grid, in f32; an event is kept when its
    cell's counter crosses +-threshold, which then moves back by it.

    Cells are independent and each is sequential in event order, so the
    r-th events of all cells are processed together, r = 0, 1, ...: the
    same f32 operations per cell in the same order as one loop over the
    events."""
    x = np.asarray(x, np.int64)
    y = np.asarray(y, np.int64)
    pol_in = np.asarray(p).reshape(-1).astype(np.float32)
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
