"""Synthetic ROL-style fixture generator (counterpart of
``eventad_tpu/data/fixtures.py``: the same seed gives the same events,
frames, tracks, timestamps, split and TOA values).

Scenes: moving rectangles on a textured background; each box edge emits
events as it moves (a crude event-camera model); in anomalous sequences one
object switches to erratic motion at a known TOA frame and its class flips
to 1 ("anomaly" in slot semantics — the reference uses bbox[:,4] as the
anomaly label, utils/train.py:111).

:func:`make_sequence` makes one sequence's arrays in memory;
:func:`write_sequence` writes them in the on-disk layout the data layer
reads (events h5 + ms_to_idx, PNG frames, timestamps.txt, tracks.npy);
:func:`generate_dataset` adds the split YAML and the TOA JSON.  ``cv2``,
``yaml`` and ``h5py`` are imported only by the writers.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

from ..config import Config
from .h5io import write_events
from .tracks import TRACK_DTYPE


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


def make_sequence(name: str, cfg: Config, *, n_frames: int = 12,
                  n_objects: int = 3, anomalous: bool = False,
                  toa_frame: int = 6, seed: int = 0,
                  events_per_window: int = 3000, ramp_frames: int = 0,
                  frame_scale: Optional[int] = None) -> dict:
    """One sequence's arrays: ``dict(name, events, timestamps, tracks,
    images, toa)`` — events as the h5 file stores them (x, y uint16, t
    int64 sorted, p uint8), frames ``[fh, fw, 3]`` uint8 (BGR, as the PNG
    reads back) at ``frame_scale`` times the model size (default
    ``cfg.scale``, the sensor size the files hold; 1 renders at model
    size, which changes the random stream after the first frame), ``toa``
    the TOA frame of an anomalous sequence, else None.

    ``ramp_frames > 0``: the anomalous object's motion blends from normal
    to fully anomalous over the ``ramp_frames`` frames BEFORE the TOA frame
    (labels still flip exactly at TOA), so the TTA threshold ladder has
    pre-onset cues to fire on."""
    rng = np.random.RandomState(seed)
    w, h = cfg.model_width, cfg.model_height

    def anom_blend(fi):
        """0 = normal motion, 1 = fully anomalous."""
        if not anomalous:
            return 0.0
        if ramp_frames <= 0:
            return 1.0 if fi >= toa_frame else 0.0
        return float(np.clip(
            (fi - (toa_frame - ramp_frames)) / ramp_frames, 0.0, 1.0))
    scale = cfg.scale
    fscale = scale if frame_scale is None else frame_scale
    fw, fh = w * fscale, h * fscale
    dt_us = 50_000  # 20 fps

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
            # DSEC vocabulary ids: the dataset's class remap turns car(2)
            # -> label 0 and pedestrian(0) -> label 1 (the anomaly label
            # channel, reference utils/train.py:111)
            cls = 0 if is_anom else 2
            # record track at this frame timestamp
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
                # faster edges cross more pixels and emit more events: the
                # anomaly's box-localized signature; ramp frames emit
                # intermediately many
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


def write_sequence(root: Path, seq: dict) -> Path:
    """Writes :func:`make_sequence`'s arrays under ``root/<name>``."""
    import cv2
    d = Path(root) / seq["name"]
    (d / "images/left/rectified").mkdir(parents=True, exist_ok=True)
    (d / "object_detections/left").mkdir(parents=True, exist_ok=True)
    for fi, img in enumerate(seq["images"]):
        cv2.imwrite(str(d / f"images/left/rectified/{fi:06d}.png"), img)
    np.savetxt(d / "images/timestamps.txt", seq["timestamps"], fmt="%d")
    write_events(d / "events/left/events_2x.h5", seq["events"])
    np.save(d / "object_detections/left/tracks.npy", seq["tracks"])
    return d


def fixture_sequences(cfg: Config, *, n_train: int = 4, n_val: int = 3,
                      n_frames: int = 12, seed: int = 0,
                      events_per_window: int = 3000,
                      val_ramp_frames: int = 6,
                      frame_scale: Optional[int] = None
                      ) -> Iterator[tuple]:
    """``(group, sequence arrays)`` of the fixture, one at a time, groups
    "train", "val" and "test" in that order; sequence ``i`` of a group is
    anomalous for even ``i``.  Val anomalies ramp in over
    ``val_ramp_frames`` frames before their TOA; the train and "test"
    groups stay abrupt (the reference trains on the split named "test",
    utils/data.py:27-30, and ramp frames are labelled normal)."""
    idx = 0
    for group, count in (("train", n_train), ("val", n_val),
                         ("test", n_train)):
        for i in range(count):
            yield group, make_sequence(
                f"synth_{group}_{i:02d}", cfg, n_frames=n_frames,
                anomalous=(i % 2 == 0), seed=seed + idx,
                events_per_window=events_per_window,
                ramp_frames=val_ramp_frames if group == "val" else 0,
                frame_scale=frame_scale)
            idx += 1


def generate_dataset(root: Path, cfg: Config, *, n_train: int = 4,
                     n_val: int = 3, n_frames: int = 12, seed: int = 0,
                     events_per_window: int = 3000,
                     val_ramp_frames: int = 6) -> Path:
    """Writes the fixture's sequences, ``rol_split.yaml`` and
    ``toa_values.json`` under ``root``.  Returns root."""
    import yaml
    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    split = {"train": [], "val": [], "test": []}
    toa = {}
    for group, seq in fixture_sequences(
            cfg, n_train=n_train, n_val=n_val, n_frames=n_frames, seed=seed,
            events_per_window=events_per_window,
            val_ramp_frames=val_ramp_frames):
        write_sequence(root, seq)
        split[group].append(seq["name"])
        if seq["toa"] is not None:
            toa[seq["name"]] = seq["toa"]
    with open(root / "rol_split.yaml", "w") as f:
        yaml.safe_dump(split, f)
    with open(root / "toa_values.json", "w") as f:
        json.dump(toa, f)
    return root
