"""Detection / event visualization overlays (counterpart of
``eventad_tpu/utils/viz.py``; ``cv2`` is imported only where a box is drawn
or a frame written).

Reference: src/dagr/visualization/bbox_viz.py:11-81 (OpenCV box drawing with
score-threshold + NMS filter) and event_viz.py:12-18 (numba polarity
overlay) — vectorized numpy/cv2 here."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

CLASS_COLORS = ((80, 80, 200), (200, 80, 80), (80, 200, 80),
                (200, 200, 80))


def draw_events(image: np.ndarray, x: np.ndarray, y: np.ndarray,
                p: np.ndarray, alpha: float = 0.5) -> np.ndarray:
    """Overlay events: positive polarity red, negative blue (event_viz)."""
    out = image.copy()
    h, w = out.shape[:2]
    ok = (x >= 0) & (x < w) & (y >= 0) & (y < h)
    xs, ys, ps = x[ok].astype(int), y[ok].astype(int), p[ok]
    pos = ps > 0
    out[ys[pos], xs[pos]] = (1 - alpha) * out[ys[pos], xs[pos]] \
        + alpha * np.array([0, 0, 255])
    out[ys[~pos], xs[~pos]] = (1 - alpha) * out[ys[~pos], xs[~pos]] \
        + alpha * np.array([255, 0, 0])
    return out.astype(np.uint8)


def draw_boxes(image: np.ndarray, boxes: np.ndarray,
               labels: Optional[np.ndarray] = None,
               scores: Optional[np.ndarray] = None,
               class_names: Sequence[str] = ("car", "pedestrian"),
               score_threshold: float = 0.3,
               xywh: bool = True) -> np.ndarray:
    """Draw boxes with class/score captions (bbox_viz semantics)."""
    import cv2
    out = np.ascontiguousarray(image.copy())
    for i, b in enumerate(np.asarray(boxes)):
        if scores is not None and scores[i] < score_threshold:
            continue
        if xywh:
            x1, y1, x2, y2 = b[0], b[1], b[0] + b[2], b[1] + b[3]
        else:
            x1, y1, x2, y2 = b[:4]
        cls = int(labels[i]) if labels is not None else 0
        color = CLASS_COLORS[cls % len(CLASS_COLORS)]
        cv2.rectangle(out, (int(x1), int(y1)), (int(x2), int(y2)), color, 1)
        cap = class_names[cls] if cls < len(class_names) else str(cls)
        if scores is not None:
            cap += f" {scores[i]:.2f}"
        cv2.putText(out, cap, (int(x1), max(int(y1) - 2, 8)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.3, color, 1)
    return out


def save_detection_frame(path, image_float, events=None, detections=None,
                         targets=None):
    """Composite debug frame: image + events + predicted/GT boxes."""
    import cv2
    img = (np.asarray(image_float) * 255).astype(np.uint8)
    if events is not None:
        img = draw_events(img, events["x"], events["y"],
                          events["p"].reshape(-1))
    if targets is not None:
        img = draw_boxes(img, targets["boxes"], targets.get("labels"),
                         xywh=False)
    if detections is not None:
        img = draw_boxes(img, detections["boxes"],
                         detections.get("labels"),
                         detections.get("scores"), xywh=False)
    cv2.imwrite(str(path), img)
    return path
