"""Graph-native data augmentations on host-side numpy items (counterpart of
``eventad_tpu/data/augment.py``: the same transforms drawing from the same
numpy ``RandomState`` streams, so one seed gives the same Items).

Reference: src/dagr/data/augment.py — RandomHFlip (:85-104), Crop (:107-136),
RandomZoom with density-preserving event subsampling (:13-37,139-189),
RandomCrop (:192-229), RandomTranslate (:232-269); training pipeline order
and constants from Augmentations (:272-284). The reference's numba
accumulator kernel is ``native.zoom_subsample_mask`` here (the port's C++,
one pass in event order); ``cv2`` is imported only by the zoom's image
resize.

Reference quirk preserved at the pipeline level: training uses the *testing*
transform (utils/data.py:27-30), i.e. none of the random augs run by default.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from ..native import zoom_subsample_mask
from .dataset import Item


def _scale_and_clip(v: float, scale: int) -> int:
    """reference augment.py:82-83."""
    return int(np.clip(v * scale, 0, scale - 1))


def _crop_events(events: dict, left, right) -> dict:
    """Drop events outside [left, right] inclusive (augment.py:39-48)."""
    ok = ((events["x"] >= left[0]) & (events["x"] <= right[0])
          & (events["y"] >= left[1]) & (events["y"] <= right[1]))
    return {k: v[ok] for k, v in events.items()}


def _crop_image(image: np.ndarray, left, right) -> np.ndarray:
    """Zero outside the crop window, keep size (augment.py:51-58)."""
    image = image.copy()
    image[:left[1], :] = 0
    image[right[1]:, :] = 0
    image[:, :left[0]] = 0
    image[:, right[0]:] = 0
    return image


def _crop_bbox(bbox: np.ndarray, left, right) -> np.ndarray:
    """Clamp [x,y,w,h] boxes into [left, right] (augment.py:73-79)."""
    b = bbox.copy()
    b[:, 2:4] += b[:, :2]
    b[:, 0] = np.clip(b[:, 0], left[0], right[0])
    b[:, 1] = np.clip(b[:, 1], left[1], right[1])
    b[:, 2] = np.clip(b[:, 2], left[0], right[0])
    b[:, 3] = np.clip(b[:, 3], left[1], right[1])
    b[:, 2:4] -= b[:, :2]
    return b


def _apply_crop(item: Item, left, right) -> Item:
    item.events = _crop_events(item.events, left, right)
    item.image = _crop_image(item.image, left, right)
    for attr in ("bbox", "bbox0"):
        b = getattr(item, attr)
        if len(b):
            setattr(item, attr, _crop_bbox(b, left, right))
    return item


class RandomHFlip:
    """reference augment.py:85-104."""

    def __init__(self, p: float = 0.5, seed: int = 0):
        self.p = p
        self.rng = np.random.RandomState(seed)

    def __call__(self, item: Item) -> Item:
        if self.rng.rand() > self.p:
            return item
        w = item.width
        item.events["x"] = (w - 1 - item.events["x"]).astype(
            item.events["x"].dtype)
        item.image = np.ascontiguousarray(item.image[:, ::-1])
        for attr in ("bbox", "bbox0"):
            b = getattr(item, attr)
            if len(b):
                b = b.copy()
                b[:, 0] = w - 1 - (b[:, 0] + b[:, 2])
                setattr(item, attr, b)
        return item


class Crop:
    """Crop to [min, max] fractions of the frame (augment.py:107-136); the
    final stage of both the training and testing pipelines."""

    def __init__(self, vmin: Sequence[float] = (0, 0),
                 vmax: Sequence[float] = (1, 1)):
        self.vmin_f = vmin
        self.vmax_f = vmax

    def _bounds(self, item: Item):
        size = (item.width, item.height)
        left = [_scale_and_clip(m, s) for m, s in zip(self.vmin_f, size)]
        right = [_scale_and_clip(m, s) for m, s in zip(self.vmax_f, size)]
        return left, right

    def __call__(self, item: Item) -> Item:
        left, right = self._bounds(item)
        return _apply_crop(item, left, right)


class RandomCrop:
    """Random window of ``size`` fractions at probability p
    (augment.py:192-229; training uses size 0.75, p 0.2)."""

    def __init__(self, size: Sequence[float] = (0.75, 0.75), p: float = 0.5,
                 seed: int = 0):
        self.size_f = size
        self.p = p
        self.rng = np.random.RandomState(seed)

    def __call__(self, item: Item) -> Item:
        if self.rng.rand() > self.p:
            return item
        full = (item.width, item.height)
        size = [_scale_and_clip(s, ss) for s, ss in zip(self.size_f, full)]
        left_max = [f - s for f, s in zip(full, size)]
        left = [int(self.rng.rand() * m) for m in left_max]
        right = [l + s for l, s in zip(left, size)]
        return _apply_crop(item, left, right)


def _resize_image(image: np.ndarray, height: int, width: int,
                  bg: Optional[np.ndarray]) -> np.ndarray:
    """reference augment.py:60-71: nearest resize; center-crop on zoom-in,
    center-paste onto a zero background on zoom-out."""
    import cv2
    new_image = cv2.resize(image, (width, height),
                           interpolation=cv2.INTER_NEAREST)
    px = (new_image.shape[1] - image.shape[1]) // 2
    py = (new_image.shape[0] - image.shape[0]) // 2
    if px >= 0:
        return new_image[py:py + image.shape[0], px:px + image.shape[1]]
    bg = bg.copy()
    bg[-py:-py + new_image.shape[0], -px:-px + new_image.shape[1]] = new_image
    return bg


class RandomZoom:
    """Zoom about the frame center by z ~ U[zoom_min, zoom_max]
    (augment.py:139-189). Positions are cast to int before the zoom-out
    subsample, so the reference's bilinear accumulator reduces to a
    per-pixel signed counter with threshold 1/z^2 (see
    native.zoom_subsample_mask). Out-of-frame events survive until the
    pipeline's final Crop, exactly like the reference."""

    def __init__(self, zoom: Sequence[float] = (1.0, 1.5), seed: int = 0,
                 subsample: bool = True):
        self.zoom = zoom
        self.subsample = subsample
        self.rng = np.random.RandomState(seed)

    def __call__(self, item: Item) -> Item:
        z = self.rng.rand() * (self.zoom[1] - self.zoom[0]) + self.zoom[0]
        w, h = item.width, item.height
        cx, cy = w // 2, h // 2
        ev = item.events
        # torch .to(int16) truncates toward zero (augment.py:173-174)
        ev["x"] = np.trunc((ev["x"] - cx) * z + cx).astype(np.int32)
        ev["y"] = np.trunc((ev["y"] - cy) * z + cy).astype(np.int32)
        if self.subsample and z < 1:
            keep = zoom_subsample_mask(ev["x"], ev["y"], ev["p"],
                                              w, h, 1.0 / (z * z))
            ev = {k: v[keep] for k, v in ev.items()}
        item.events = ev
        nw, nh = int(np.ceil(w * z)), int(np.ceil(h * z))
        bg = np.zeros_like(item.image) if z < 1 else None
        item.image = _resize_image(item.image, nh, nw, bg)
        for attr in ("bbox", "bbox0"):
            b = getattr(item, attr)
            if len(b):
                b = b.astype(np.float64).copy()
                b[:, 2:4] *= z
                b[:, 0] = (b[:, 0] - cx) * z + cx
                b[:, 1] = (b[:, 1] - cy) * z + cy
                setattr(item, attr, b)
        return item


class RandomTranslate:
    """Shift everything by up to +-size fractions (augment.py:232-269); no
    clipping here — the final Crop clamps, like the reference."""

    def __init__(self, size: float = 0.1, seed: int = 0):
        self.size_f = (size, size)
        self.rng = np.random.RandomState(seed)

    def __call__(self, item: Item) -> Item:
        full = (item.width, item.height)
        size = [_scale_and_clip(s, ss) for s, ss in zip(self.size_f, full)]
        move = [int(s * (self.rng.rand() * 2 - 1)) for s in size]
        ev = item.events
        ev["x"] = (ev["x"] + move[0]).astype(np.int32)
        ev["y"] = (ev["y"] + move[1]).astype(np.int32)
        item.events = ev
        # pad by `size`, then cut the window shifted by -move
        # (augment.py:252-257)
        sy, sx = size[1], size[0]
        pad = np.zeros((item.image.shape[0] + 2 * sy,
                        item.image.shape[1] + 2 * sx,
                        item.image.shape[2]), item.image.dtype)
        pad[sy:sy + item.image.shape[0], sx:sx + item.image.shape[1]] = \
            item.image
        item.image = pad[sy - move[1]:sy - move[1] + item.height,
                         sx - move[0]:sx - move[0] + item.width]
        for attr in ("bbox", "bbox0"):
            b = getattr(item, attr)
            if len(b):
                b = b.copy()
                b[:, 0] += move[0]
                b[:, 1] += move[1]
                setattr(item, attr, b)
        return item


class Compose:
    def __init__(self, transforms: List):
        self.transforms = transforms

    def __call__(self, item: Item) -> Item:
        for t in self.transforms:
            item = t(item)
        return item


def training_transform(cfg, seed: int = 0) -> Compose:
    """reference Augmentations.transform_training (augment.py:272-284):
    HFlip(p_flip) -> RandomCrop(0.75, p=0.2) -> Zoom([min,max], subsample)
    -> Translate(trans) -> Crop([0,1])."""
    zoom_min = getattr(cfg, "aug_zoom_min", 1.0)
    return Compose([
        RandomHFlip(cfg.aug_p_flip, seed),
        RandomCrop((0.75, 0.75), p=0.2, seed=seed + 3),
        RandomZoom((zoom_min, cfg.aug_zoom), seed=seed + 1),
        RandomTranslate(cfg.aug_trans, seed=seed + 2),
        Crop((0, 0), (1, 1)),
    ])


def testing_transform(cfg) -> Compose:
    """The reference test transform is Crop-only (augment.py:272-284)."""
    return Compose([Crop((0, 0), (1, 1))])
