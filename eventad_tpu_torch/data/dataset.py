"""Sequence dataset: image pairs + event windows + tracks (counterpart of
``eventad_tpu/data/dataset.py``; reference ``DSEC`` dataset,
src/dagr/data/dsec_data.py:51-192), on the same on-disk layout (one
directory per sequence):

    <root>/<sequence>/
        events/left/events_2x.h5            (events + ms_to_idx)
        images/left/rectified/NNNNNN.png    (20 fps frames)
        images/timestamps.txt               (us timestamp per frame)
        object_detections/left/tracks.npy   (TRACK_DTYPE structured array)

One item = consecutive image pair (i, i+1): tracks at both timestamps,
image i, and the events of the window ending at image i+1
(dsec_data.py:139-181), rebased so the window ends at ``time_window`` and
polarity mapped to +-1.  ``SequenceDataset.__getitem__`` reads the arrays
(timestamps, tracks, events, image) and :func:`cut_item`, a function of
arrays only, cuts the Item; :class:`MemoryDataset` cuts the Items of
sequences held in memory with the same function.  ``yaml`` (the split
file), ``h5py`` (the events) and ``cv2`` (the images, read as BGR and
resized with ``INTER_CUBIC`` as the JAX package does) are imported only
where a file is read.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..config import Config
from ..native import window_rebase
from ..utils.spans import span
from .h5io import EventFile
from .tracks import (DEFAULT_MAPPING, DSEC_CLASSES, compute_class_mapping,
                     filter_small_bboxes, interpolate_tracks,
                     preprocess_tracks, tracks_to_array)


@dataclasses.dataclass
class SequenceDir:
    root: Path

    @property
    def name(self):
        return self.root.name

    @property
    def event_file(self):
        return self.root / "events/left/events_2x.h5"

    @property
    def image_dir(self):
        return self.root / "images/left/rectified"

    @property
    def timestamps_file(self):
        return self.root / "images/timestamps.txt"

    @property
    def tracks_file(self):
        return self.root / "object_detections/left/tracks.npy"


@dataclasses.dataclass
class Item:
    """One training/eval sample (host-side, numpy)."""
    events: Dict[str, np.ndarray]      # x, y int; t int us in [0, Tw]; p +-1
    image: np.ndarray                  # [H, W, 3] uint8, BGR
    bbox: np.ndarray                   # [n, 6] x,y,w,h,class,track (frame i+1)
    bbox0: np.ndarray                  # [m, 6] (frame i)
    sequence: str
    frame_id: int
    width: int
    height: int
    time_window: int


def load_split(split_yaml: str) -> Dict[str, List[str]]:
    import yaml
    with open(split_yaml) as f:
        return yaml.safe_load(f)


def cut_item(raw: Dict[str, np.ndarray], t_offset: int, tracks: np.ndarray,
             t0: int, t1: int, image: np.ndarray, *, sequence: str,
             frame_id: int, scale: int, width: int, height: int,
             time_window: int, remap: np.ndarray, num_us: int = -1,
             no_eval: bool = False, transform=None,
             min_bbox_height: float = 0,
             min_bbox_diag: float = 0) -> Item:
    """The Item of the frame pair at ``t0``, ``t1`` (us) from arrays:
    ``raw`` events as stored (x, y uint16, t int64 sorted and relative to
    ``t_offset``, p uint8; the whole sequence or any range that holds the
    window), the sequence's ``tracks`` and frame ``t0``'s ``image`` at model
    size.  ``num_us >= 0`` ends the window ``num_us`` after ``t0`` and
    interpolates the second frame's tracks to it (unless ``no_eval``)."""
    det0 = preprocess_tracks(tracks[tracks["t"] == t0], scale, width, height,
                             remap)
    det1 = preprocess_tracks(tracks[tracks["t"] == t1], scale, width, height,
                             remap)
    t1_eff = t0 + num_us if num_us >= 0 else t1
    if num_us >= 0 and not no_eval:
        det1 = interpolate_tracks(det0, det1, t1_eff)
    ev = window_rebase(raw, t0 - t_offset, t1_eff - t_offset, time_window,
                       height)
    item = Item(events=ev, image=image, bbox=tracks_to_array(det1),
                bbox0=tracks_to_array(det0), sequence=sequence,
                frame_id=frame_id, width=width, height=height,
                time_window=time_window)
    if transform is not None:
        item = transform(item)
    # drop degenerate boxes (dsec_data.py:175-179)
    for attr in ("bbox", "bbox0"):
        b = getattr(item, attr)
        if len(b):
            keep = filter_small_bboxes(b[:, 2], b[:, 3], min_bbox_height,
                                       min_bbox_diag)
            setattr(item, attr, b[keep])
    return item


class _Items:
    """What both datasets share: the geometry, the class remap, the
    transform and ``set_num_us``."""

    def __init__(self, cfg: Config, transform, classes, min_bbox_height,
                 min_bbox_diag, all_classes, mapping):
        self.cfg = cfg
        self.scale = cfg.scale
        self.time_window = cfg.time_window_us
        self.num_us = -1
        self.no_eval = cfg.no_eval
        self.transform = transform
        self.min_bbox_height = min_bbox_height
        self.min_bbox_diag = min_bbox_diag
        self.remap = compute_class_mapping(classes, all_classes,
                                           mapping or DEFAULT_MAPPING)
        # model geometry (dsec_data.py:83-84: width // scale)
        self.width = cfg.model_width
        self.height = cfg.model_height
        self.index: List[tuple] = []   # (sequence index, image index 0)

    def __len__(self):
        return len(self.index)

    def set_num_us(self, num_us: int):
        self.num_us = num_us

    def _window_end(self, t0: int, t1: int) -> int:
        return t0 + self.num_us if self.num_us >= 0 else t1

    def _cut(self, raw, t_offset, tracks, t0, t1, image, sequence,
             frame_id) -> Item:
        return cut_item(raw, t_offset, tracks, t0, t1, image,
                        sequence=sequence, frame_id=frame_id,
                        scale=self.scale, width=self.width,
                        height=self.height, time_window=self.time_window,
                        remap=self.remap, num_us=self.num_us,
                        no_eval=self.no_eval, transform=self.transform,
                        min_bbox_height=self.min_bbox_height,
                        min_bbox_diag=self.min_bbox_diag)


class SequenceDataset(_Items):
    """The Items of a split's sequence directories.  ``preload_events``
    (default on) reads each sequence's events whole once and cuts windows
    from memory; off, every item reads its window from the h5 file."""

    def __init__(self, cfg: Config, root: Path, split: str,
                 transform=None, classes=("car", "pedestrian"),
                 min_bbox_height: float = 0, min_bbox_diag: float = 0,
                 all_classes: Sequence[str] = DSEC_CLASSES,
                 mapping: Optional[dict] = None):
        super().__init__(cfg, transform, classes, min_bbox_height,
                         min_bbox_diag, all_classes, mapping)
        root = Path(root)
        self.preload_events = True
        # a dangling split file is an error: split="" explicitly opts into
        # every subdirectory of root
        if cfg.split:
            if not Path(cfg.split).exists():
                raise FileNotFoundError(
                    f"split file {cfg.split!r} does not exist; pass "
                    f"--split '' to use every subdirectory of {root}")
            split_cfg = load_split(cfg.split)
            if split not in split_cfg:
                raise KeyError(
                    f"split {split!r} not in {cfg.split!r} "
                    f"(has: {sorted(split_cfg)})")
            self.dirs = [SequenceDir(root / n) for n in split_cfg[split]
                         if (root / n).exists()]
        else:
            self.dirs = [SequenceDir(p) for p in sorted(root.iterdir())
                         if p.is_dir()]

        self._events: Dict[str, EventFile] = {}
        self._preload_cache: Dict[str, tuple] = {}
        self._tracks: Dict[str, np.ndarray] = {}
        self._timestamps: Dict[str, np.ndarray] = {}
        for si, d in enumerate(self.dirs):
            ts = np.loadtxt(d.timestamps_file, dtype=np.int64, ndmin=1)
            self._timestamps[d.name] = ts
            self._tracks[d.name] = np.load(d.tracks_file)
            self.index.extend((si, i) for i in range(len(ts) - 1))

    def _event_file(self, d: SequenceDir) -> EventFile:
        if d.name not in self._events:
            self._events[d.name] = EventFile(d.event_file)
        return self._events[d.name]

    def _read_events(self, d: SequenceDir, t0: int, t1: int):
        """``(raw events, t_offset)`` holding the window ``[t0, t1)``."""
        if self.preload_events:
            if d.name not in self._preload_cache:
                ef = self._event_file(d)
                self._preload_cache[d.name] = (ef.read_all(), ef.t_offset)
            return self._preload_cache[d.name]
        ef = self._event_file(d)
        toff = ef.t_offset
        return ef.load_window(t0 - toff, t1 - toff), toff

    def _load_image(self, d: SequenceDir, idx: int) -> np.ndarray:
        import cv2
        img = cv2.imread(str(d.image_dir / f"{idx:06d}.png"))
        if img is None:
            img = np.zeros((self.height * self.scale,
                            self.width * self.scale, 3), np.uint8)
        img = img[:self.scale * self.height]
        return cv2.resize(img, (self.width, self.height),
                          interpolation=cv2.INTER_CUBIC)

    def __getitem__(self, idx: int) -> Item:
        with span("data/item"):
            si, i0 = self.index[idx]
            d = self.dirs[si]
            ts = self._timestamps[d.name]
            t0, t1 = int(ts[i0]), int(ts[i0 + 1])
            with span("data/read"):
                raw, toff = self._read_events(d, t0,
                                              self._window_end(t0, t1))
            return self._cut(raw, toff, self._tracks[d.name], t0, t1,
                             self._load_image(d, i0), d.name, i0 + 1)


class MemoryDataset(_Items):
    """The Items of sequences held in memory: each a mapping with
    ``name``, ``events`` (x, y, t, p as stored in the h5 file, t_offset
    0), ``timestamps``, ``tracks`` and ``images`` (one ``[H, W, 3]`` uint8
    frame per timestamp at model size), as ``data/fixtures.make_sequence``
    returns them.  Reads no file."""

    def __init__(self, cfg: Config, sequences: Sequence[dict],
                 transform=None, classes=("car", "pedestrian"),
                 min_bbox_height: float = 0, min_bbox_diag: float = 0,
                 all_classes: Sequence[str] = DSEC_CLASSES,
                 mapping: Optional[dict] = None):
        super().__init__(cfg, transform, classes, min_bbox_height,
                         min_bbox_diag, all_classes, mapping)
        self.sequences = list(sequences)
        want = (self.height, self.width, 3)
        for si, s in enumerate(self.sequences):
            if any(im.shape != want for im in s["images"]):
                raise ValueError(f"{s['name']}: frames are not {want}")
            self.index.extend((si, i) for i in range(len(s["timestamps"])
                                                     - 1))

    def __getitem__(self, idx: int) -> Item:
        with span("data/item"):
            si, i0 = self.index[idx]
            s = self.sequences[si]
            ts = s["timestamps"]
            return self._cut(s["events"], 0, s["tracks"], int(ts[i0]),
                             int(ts[i0 + 1]), s["images"][i0], s["name"],
                             i0 + 1)


def check_dataset_balance(loaders) -> dict:
    """Class-balance report over loaders (reference utils/data.py:67-96:
    counts normal/anomaly boxes and their ratio)."""
    out = {}
    for name, loader in loaders.items():
        normal = anomaly = 0
        for batch, _meta in loader:
            labels = batch.bbox[batch.bbox_mask][:, 4]
            anomaly += int((labels > 0.5).sum())
            normal += int((labels <= 0.5).sum())
        total = max(normal + anomaly, 1)
        out[name] = dict(normal=normal, anomaly=anomaly,
                         anomaly_ratio=anomaly / total)
        print(f"{name}: normal {normal}, anomaly {anomaly} "
              f"({anomaly / total:.1%})")
    return out
