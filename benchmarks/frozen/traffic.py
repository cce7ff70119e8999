"""The traffic generator: a frozen copy of
``eventad_tpu_torch/data/fixtures.make_sequence`` (moving rectangles whose
leading edges emit events, one object of an anomalous sequence switching
to erratic motion and emitting four times as many).

One addition: ``frame_us``, the frame interval (50 000 us, 20 fps, in the
original; DoTA's footage runs at 10 fps).  At the default every array
equals the original's from the same seed.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

TRACK_DTYPE = np.dtype([
    ("t", "<u8"), ("x", "<f4"), ("y", "<f4"), ("w", "<f4"), ("h", "<f4"),
    ("class_id", "u1"), ("class_confidence", "<f4"), ("track_id", "<i4"),
])


def _render_image(w, h, boxes, rng):
    img = np.full((h, w, 3), 96, np.uint8)
    # static texture
    img += (rng.rand(h, w, 3) * 24).astype(np.uint8)
    for (x, y, bw, bh, cls) in boxes:
        x0, y0 = int(max(x, 0)), int(max(y, 0))
        x1, y1 = int(min(x + bw, w)), int(min(y + bh, h))
        if x1 > x0 and y1 > y0:
            color = (200, 80, 80) if cls else (80, 80, 200)
            img[y0:y1, x0:x1] = color
    return img


def _emit_box_events(x, y, bw, bh, vx, vy, t0, t1, w, h, rng, rate=600):
    """Events along the leading edges of a moving box."""
    n = max(int(rate * (t1 - t0) / 1e6), 4)
    ts = np.sort(rng.randint(t0, t1, n))
    frac = (ts - t0) / max(t1 - t0, 1)
    cx = x + vx * frac * (t1 - t0) / 1e6
    cy = y + vy * frac * (t1 - t0) / 1e6
    # sample points on the box perimeter
    side = rng.randint(0, 4, n)
    u = rng.rand(n)
    ex = np.where(side < 2, cx + u * bw, np.where(side == 2, cx, cx + bw))
    ey = np.where(side == 0, cy, np.where(side == 1, cy + bh, cy + u * bh))
    p = (rng.rand(n) > 0.5).astype(np.uint8)
    ok = (ex >= 0) & (ex < w) & (ey >= 0) & (ey < h)
    return ex[ok].astype(np.uint16), ey[ok].astype(np.uint16), \
        ts[ok].astype(np.int64), p[ok]


def make_sequence(name: str, width: int, height: int, scale: int, *,
                  n_frames: int = 12, n_objects: int = 3,
                  anomalous: bool = False, toa_frame: int = 6, seed: int = 0,
                  events_per_window: int = 3000, ramp_frames: int = 0,
                  frame_scale: Optional[int] = None,
                  frame_us: int = 50_000) -> dict:
    """One sequence's arrays at model size ``width`` x ``height`` (the
    sensor is ``scale`` times larger): ``dict(name, events, timestamps,
    tracks, images, toa)``, events as an h5 file stores them (x, y uint16,
    t int64 sorted, p uint8), frames ``[fh, fw, 3]`` uint8 at
    ``frame_scale`` times the model size (default ``scale``), tracks in
    sensor pixels, ``toa`` the TOA frame of an anomalous sequence."""
    rng = np.random.RandomState(seed)
    w, h = width, height

    def anom_blend(fi):
        """0 = normal motion, 1 = fully anomalous."""
        if not anomalous:
            return 0.0
        if ramp_frames <= 0:
            return 1.0 if fi >= toa_frame else 0.0
        return float(np.clip(
            (fi - (toa_frame - ramp_frames)) / ramp_frames, 0.0, 1.0))
    fscale = scale if frame_scale is None else frame_scale
    fw, fh = w * fscale, h * fscale
    dt_us = frame_us

    # objects: x, y, w, h, vx, vy (px/s at model res), track_id
    objs = []
    for i in range(n_objects):
        bw = rng.randint(max(w // 12, 4), max(w // 6, 8))
        bh = rng.randint(max(h // 12, 4), max(h // 6, 8))
        objs.append(dict(
            x=float(rng.randint(0, max(w - bw, 1))),
            y=float(rng.randint(0, max(h - bh, 1))),
            w=float(bw), h=float(bh),
            vx=float(rng.randn() * w * 0.15), vy=float(rng.randn() * h * 0.1),
            drift=1.0, tid=i + 1))

    timestamps = (np.arange(n_frames, dtype=np.int64) * dt_us
                  + 1_000_000)
    all_ev = {k: [] for k in "xytp"}
    tracks, images = [], []
    for fi, t_img in enumerate(timestamps):
        boxes_draw = []
        for oi, o in enumerate(objs):
            is_anom = anomalous and oi == 0 and fi >= toa_frame
            # DSEC vocabulary ids: car(2) -> label 0, pedestrian(0) ->
            # label 1 (the anomaly label)
            cls = 0 if is_anom else 2
            x = float(np.clip(o["x"], 0, w - 2))
            y = float(np.clip(o["y"], 0, h - 2))
            bw = float(min(o["w"], w - 1 - x))
            bh = float(min(o["h"], h - 1 - y))
            tracks.append((t_img, x * scale, y * scale, bw * scale,
                           bh * scale, cls, 1.0, o["tid"]))
            boxes_draw.append((x * fscale, y * fscale, bw * fscale,
                               bh * fscale, 1 if is_anom else 0))
            # events emitted over the window ending at this frame
            if fi > 0:
                vx, vy = o["vx"], o["vy"]
                g = anom_blend(fi) if oi == 0 else 0.0
                if g > 0:
                    vx = vx * (1 + 4 * g) + o["drift"] * w * 0.5 * g
                    vy = vy * (1 + 4 * g)
                ex, ey, ts, p = _emit_box_events(
                    x, y, bw, bh, vx, vy, int(timestamps[fi - 1]),
                    int(t_img), w, h, rng,
                    rate=int(events_per_window * 20 * (1 + 3 * g)
                             // max(n_objects, 1)))
                all_ev["x"].append(ex)
                all_ev["y"].append(ey)
                all_ev["t"].append(ts)
                all_ev["p"].append(p)
            # advance object; bounce at the frame edge
            vx, vy = o["vx"], o["vy"]
            g = anom_blend(fi) if oi == 0 else 0.0
            if g > 0:
                vx = vx * (1 + 4 * g) + o["drift"] * w * 0.5 * g
                vy = vy * (1 + 4 * g)
            o["x"] = float(np.clip(o["x"] + vx * dt_us / 1e6, 0, w - 4))
            o["y"] = float(np.clip(o["y"] + vy * dt_us / 1e6, 0, h - 4))
            if o["x"] <= 0 or o["x"] >= w - 4:
                o["vx"] = -o["vx"]
                o["drift"] = -o["drift"]
            if o["y"] <= 0 or o["y"] >= h - 4:
                o["vy"] = -o["vy"]
        images.append(_render_image(fw, fh, boxes_draw, rng))

    stored = dict(x=np.uint16, y=np.uint16, t=np.int64, p=np.uint8)
    ev = {k: (np.concatenate(v) if v else np.zeros((0,))).astype(stored[k])
          for k, v in all_ev.items()}
    order = np.argsort(ev["t"], kind="stable")
    return dict(name=name, events={k: v[order] for k, v in ev.items()},
                timestamps=timestamps,
                tracks=np.array(tracks, dtype=TRACK_DTYPE), images=images,
                toa=toa_frame if anomalous else None)
