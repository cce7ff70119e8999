"""Object-track handling: the ``tracks.npy`` structured-array format and the
preprocessing chain (rescale, crop, class remap, size filter); the same
functions as ``eventad_tpu/data/tracks.py``.

Reference: ``scripts/track.py`` (writer), ``src/dagr/data/dsec_utils.py:14-78``
(filters), ``src/dagr/data/dsec_data.py:52-55,118-122`` (class mapping).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

TRACK_DTYPE = np.dtype([
    ("t", "<u8"), ("x", "<f4"), ("y", "<f4"), ("w", "<f4"), ("h", "<f4"),
    ("class_id", "u1"), ("class_confidence", "<f4"), ("track_id", "<i4"),
])

# reference dsec_data.py:52-53
DEFAULT_MAPPING = dict(pedestrian="pedestrian", rider=None, car="car",
                       bus="car", truck="car", bicycle=None, motorcycle=None,
                       train=None)
DSEC_CLASSES = ("pedestrian", "rider", "car", "bus", "truck", "bicycle",
                "motorcycle", "train")


def compute_class_mapping(classes: Sequence[str],
                          all_classes: Sequence[str],
                          mapping: Dict[str, str]) -> np.ndarray:
    """old class id -> new class id, -1 = dropped (dsec_utils semantics)."""
    out = np.full(len(all_classes), -1, dtype=np.int64)
    for i, name in enumerate(all_classes):
        tgt = mapping.get(name)
        if tgt is not None and tgt in classes:
            out[i] = classes.index(tgt)
    return out


def map_classes(class_ids: np.ndarray, remap: np.ndarray):
    new = remap[class_ids.astype(np.int64)]
    return new, new >= 0


def rescale_tracks(tracks: np.ndarray, scale: float) -> np.ndarray:
    t = tracks.copy()
    for k in "xywh":
        t[k] = t[k] / scale
    return t


def crop_tracks(tracks: np.ndarray, width: int, height: int) -> np.ndarray:
    """Clip boxes into the image (reference crop_tracks)."""
    t = tracks.copy()
    x1 = np.clip(t["x"], 0, width - 1)
    y1 = np.clip(t["y"], 0, height - 1)
    x2 = np.clip(t["x"] + t["w"], 0, width - 1)
    y2 = np.clip(t["y"] + t["h"], 0, height - 1)
    t["x"], t["y"], t["w"], t["h"] = x1, y1, x2 - x1, y2 - y1
    return t


def filter_small_bboxes(w: np.ndarray, h: np.ndarray,
                        min_height: float = 0,
                        min_diag: float = 0) -> np.ndarray:
    """reference dsec_utils filter + dsec_data.py:175-179 usage."""
    diag = np.sqrt(w.astype(np.float64) ** 2 + h.astype(np.float64) ** 2)
    return (diag > min_diag) & (h > min_height) & (w > 0) & (h > 0)


def tracks_to_array(tracks: np.ndarray) -> np.ndarray:
    """[x, y, w, h, class_id, track_id] float32 (dsec_data.py:18-19)."""
    return np.stack([tracks["x"], tracks["y"], tracks["w"], tracks["h"],
                     tracks["class_id"].astype(np.float32),
                     tracks["track_id"].astype(np.float32)],
                    axis=1).astype(np.float32)


def interpolate_tracks(det0: np.ndarray, det1: np.ndarray,
                       t: float) -> np.ndarray:
    """Linear interpolation between two aligned detections sets
    (dsec_data.py:23-42)."""
    if len(det0) == 0 or len(det0) != len(det1):
        return det1
    det0 = det0[np.argsort(det0["track_id"])]
    det1 = det1[np.argsort(det1["track_id"])]
    t0, t1 = det0["t"][0], det1["t"][0]
    if not t0 < t1:
        return det1
    r = (t - t0) / (t1 - t0)
    out = det0.copy()
    for k in "xywh":
        out[k] = det0[k] * (1 - r) + det1[k] * r
    return out


def preprocess_tracks(tracks: np.ndarray, scale: float, width: int,
                      height: int, remap: np.ndarray) -> np.ndarray:
    """Full chain of dsec_data.preprocess_detections (dsec_data.py:118-122)."""
    t = rescale_tracks(tracks, scale)
    t = crop_tracks(t, width, height)
    new_ids, keep = map_classes(t["class_id"], remap)
    t = t[keep]
    t = t.copy()
    t["class_id"] = new_ids[keep]
    return t
