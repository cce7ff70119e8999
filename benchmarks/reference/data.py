"""The reference's own data path, in numpy: the item of a frame pair cut
from a generated sequence (the window's events rebased, the boxes of both
frames scaled, clipped and remapped to the two classes) and the padded
batch of items (the smallest bucket that holds the largest item, per-pixel
queue ranks, boxes in track slots).  Plain copies of the semantics of the
program's ``data/dataset.cut_item``, ``data/tracks`` and
``data/batching.collate_arrays``, written without its native library."""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .geometry import Geometry

MAX_DETECTIONS = 64
# DSEC class vocabulary -> (car, pedestrian): car, bus, truck -> 0,
# pedestrian -> 1, the rest dropped
DSEC_CLASSES = ("pedestrian", "rider", "car", "bus", "truck", "bicycle",
                "motorcycle", "train")
REMAP = np.array([1, -1, 0, 0, 0, -1, -1, -1], np.int64)


def window_events(events: dict, t0: int, t1: int, time_window: int,
                  height: int) -> dict:
    """The events with ``t0 <= t < t1`` and ``y < height``, their times
    rebased so the window ends at ``time_window``, polarity +-1."""
    x, y, t, p = (np.asarray(events[k]) for k in "xytp")
    i0, i1 = np.searchsorted(t, (t0, t1))
    keep = y[i0:i1] < height
    tt = t[i0:i1][keep]
    if len(tt):
        tt = time_window + tt - tt[-1]
    return dict(x=x[i0:i1][keep].astype(np.int32),
                y=y[i0:i1][keep].astype(np.int32),
                t=tt.astype(np.int32),
                p=(2 * p[i0:i1][keep].astype(np.int32) - 1).astype(np.int8))


def frame_boxes(tracks: np.ndarray, t: int, geo: Geometry) -> np.ndarray:
    """``[n, 6]`` (x, y, w, h, class, track) of the boxes at time ``t`` at
    model size, clipped into the image, classes remapped, degenerate boxes
    dropped."""
    tr = tracks[tracks["t"] == t]
    w, h = geo.model_width, geo.model_height
    x, y = tr["x"] / geo.scale, tr["y"] / geo.scale
    bw, bh = tr["w"] / geo.scale, tr["h"] / geo.scale
    x1, y1 = np.clip(x, 0, w - 1), np.clip(y, 0, h - 1)
    x2, y2 = np.clip(x + bw, 0, w - 1), np.clip(y + bh, 0, h - 1)
    cls = REMAP[tr["class_id"].astype(np.int64)]
    out = np.stack([x1, y1, x2 - x1, y2 - y1, cls.astype(np.float32),
                    tr["track_id"].astype(np.float32)], 1).astype(np.float32)
    out = out[cls >= 0]
    ok = ((np.sqrt(out[:, 2].astype(np.float64) ** 2
                   + out[:, 3].astype(np.float64) ** 2) > 0)
          & (out[:, 2] > 0) & (out[:, 3] > 0))
    return out[ok]


def cut(seq: dict, i0: int, geo: Geometry) -> dict:
    """The item of frames ``i0`` and ``i0 + 1`` of a generated sequence."""
    ts = seq["timestamps"]
    t0, t1 = int(ts[i0]), int(ts[i0 + 1])
    return dict(events=window_events(seq["events"], t0, t1,
                                     geo.time_window_us, geo.model_height),
                image=seq["images"][i0],
                bbox=frame_boxes(seq["tracks"], t1, geo),
                bbox0=frame_boxes(seq["tracks"], t0, geo))


def queue_ranks(x, y, width: int, height: int) -> np.ndarray:
    """Per-pixel recency rank: the number of later events at the same
    pixel."""
    x = np.asarray(x, np.int64)
    y = np.asarray(y, np.int64)
    n = len(x)
    if n and ((x < 0) | (x >= width) | (y < 0) | (y >= height)).any():
        raise ValueError("queue_ranks: an event lies outside the frame")
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


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _slot_boxes(bbox: np.ndarray, max_boxes: int):
    """The first box of each track id in its slot."""
    s = max_boxes + 1
    out = np.zeros((s, 4), np.float32)
    present = np.zeros((s,), bool)
    labels = np.zeros((s,), np.int32)
    for row in bbox:
        tid = int(row[5])
        if tid < 1 or tid > max_boxes or present[tid]:
            continue
        out[tid] = row[:4]
        present[tid] = True
        labels[tid] = int(row[4])
    return out, present, labels


def collate(items: list, geo: Geometry) -> dict:
    """The padded batch of ``items`` as numpy arrays: ``pos [B, N, 3]``,
    ``polarity``, ``valid``, ``rank``, ``image [B, H, W, 3]`` in [0, 1],
    ``boxes [B, 2, S, 4]``, ``box_present [B, 2, S]``, ``box_labels [B,
    S]``, and ``n_boxes``, the boxes of both frames (bbox + bbox0)."""
    b, s = geo.batch_size, geo.max_boxes + 1
    h, w = geo.model_height, geo.model_width
    n_max = max((len(it["events"]["t"]) for it in items), default=1)
    n_cap = pick_bucket(max(n_max, 1), geo.event_buckets)
    out = dict(pos=np.zeros((b, n_cap, 3), np.int32),
               polarity=np.zeros((b, n_cap), np.float32),
               valid=np.zeros((b, n_cap), bool),
               rank=np.full((b, n_cap), 2 ** 30, np.int32),
               image=np.zeros((b, h, w, 3), np.float32),
               boxes=np.zeros((b, 2, s, 4), np.float32),
               box_present=np.zeros((b, 2, s), bool),
               box_labels=np.zeros((b, s), np.int32))
    n_boxes = 0
    for i, it in enumerate(items[:b]):
        ev = it["events"]
        n_all = len(ev["t"])
        n = min(n_all, n_cap)
        sl = slice(n_all - n, n_all)
        out["pos"][i, :n, 0] = ev["x"][sl]
        out["pos"][i, :n, 1] = ev["y"][sl]
        out["pos"][i, :n, 2] = ev["t"][sl]
        out["polarity"][i, :n] = ev["p"][sl].astype(np.float32)
        out["valid"][i, :n] = True
        out["rank"][i, :n] = queue_ranks(ev["x"][sl], ev["y"][sl], w, h)
        out["image"][i] = it["image"].astype(np.float32) / 255.0
        b1, p1, l1 = _slot_boxes(it["bbox"], geo.max_boxes)
        b0, p0, _ = _slot_boxes(it["bbox0"], geo.max_boxes)
        out["boxes"][i, 1], out["box_present"][i, 1] = b1, p1
        out["box_labels"][i] = l1
        out["boxes"][i, 0], out["box_present"][i, 0] = b0, p0
        n_boxes += (min(len(it["bbox"]), MAX_DETECTIONS)
                    + min(len(it["bbox0"]), MAX_DETECTIONS))
    out["n_boxes"] = n_boxes
    return out
