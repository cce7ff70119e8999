"""Detection evaluation: accumulating buffer + IoU mAP (counterpart of
``eventad_tpu/utils/detection_eval.py``, numpy only).

Reference: ``DetectionBuffer`` (src/dagr/utils/buffers.py:99-192) accumulates
detections/ground truth per image and computes a naive 11-point-free mAP by
greedy IoU matching; ``coco_eval.py`` adds Prophesee-style time-windowed
COCO evaluation. This is the same contract in plain numpy (no detectron2
dependency): per-class AP via PR integration at configurable IoU
thresholds, mAP@[.5:.95] like COCO, plus mAP@0.5.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def box_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a [N, 4], b [M, 4] xyxy -> [N, M]."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    ax1, ay1, ax2, ay2 = a[:, 0, None], a[:, 1, None], a[:, 2, None], \
        a[:, 3, None]
    bx1, by1, bx2, by2 = b[None, :, 0], b[None, :, 1], b[None, :, 2], \
        b[None, :, 3]
    iw = np.maximum(np.minimum(ax2, bx2) - np.maximum(ax1, bx1), 0)
    ih = np.maximum(np.minimum(ay2, by2) - np.maximum(ay1, by1), 0)
    inter = iw * ih
    area_a = np.maximum(ax2 - ax1, 0) * np.maximum(ay2 - ay1, 0)
    area_b = np.maximum(bx2 - bx1, 0) * np.maximum(by2 - by1, 0)
    return inter / np.maximum(area_a + area_b - inter, 1e-9)


def average_precision(recall: np.ndarray, precision: np.ndarray) -> float:
    """COCO-style 101-point interpolation."""
    if len(recall) == 0:
        return 0.0
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[0.0], precision, [0.0]])
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    xs = np.linspace(0, 1, 101)
    return float(np.mean(np.interp(xs, mrec, mpre)))


class DetectionBuffer:
    """Accumulate (detections, targets) per image; compute mAP.

    Each detection: dict with 'boxes' [N,4] xyxy, 'scores' [N],
    'labels' [N]; target: dict with 'boxes', 'labels'."""

    def __init__(self, num_classes: int = 2,
                 iou_thresholds=None):
        self.num_classes = num_classes
        self.iou_thresholds = (np.arange(0.5, 1.0, 0.05)
                               if iou_thresholds is None
                               else np.asarray(iou_thresholds))
        self.dets: List[dict] = []
        self.gts: List[dict] = []

    def update(self, detections: List[dict], targets: List[dict]):
        for d, t in zip(detections, targets):
            self.dets.append({k: np.asarray(v) for k, v in d.items()})
            self.gts.append({k: np.asarray(v) for k, v in t.items()})

    def _ap_for(self, cls: int, iou_thr: float) -> float:
        scores, matches = [], []
        n_gt = 0
        for det, gt in zip(self.dets, self.gts):
            dmask = det["labels"] == cls
            if "mask" in det:
                dmask = dmask & det["mask"].astype(bool)
            gmask = gt["labels"] == cls
            db, ds = det["boxes"][dmask], det["scores"][dmask]
            gb = gt["boxes"][gmask]
            n_gt += len(gb)
            if len(db) == 0:
                continue
            order = np.argsort(-ds)
            db, ds = db[order], ds[order]
            iou = box_iou(db, gb)
            taken = np.zeros(len(gb), bool)
            for i in range(len(db)):
                scores.append(ds[i])
                if len(gb) == 0:
                    matches.append(0)
                    continue
                j = int(np.argmax(np.where(taken, -1.0, iou[i])))
                if iou[i, j] >= iou_thr and not taken[j]:
                    taken[j] = True
                    matches.append(1)
                else:
                    matches.append(0)
        if n_gt == 0 or not scores:
            return float("nan")
        scores = np.asarray(scores)
        matches = np.asarray(matches)
        order = np.argsort(-scores)
        tp = np.cumsum(matches[order])
        fp = np.cumsum(1 - matches[order])
        recall = tp / n_gt
        precision = tp / np.maximum(tp + fp, 1e-9)
        return average_precision(recall, precision)

    def compute(self) -> Dict[str, float]:
        per_thr = []
        ap50 = []
        for thr in self.iou_thresholds:
            aps = [self._ap_for(c, thr) for c in range(self.num_classes)]
            aps = [a for a in aps if a == a]
            per_thr.append(np.mean(aps) if aps else float("nan"))
            if abs(thr - 0.5) < 1e-9:
                ap50 = per_thr[-1]
        valid = [v for v in per_thr if v == v]
        return {
            "mAP": float(np.mean(valid)) if valid else float("nan"),
            "mAP_50": float(ap50) if ap50 == ap50 else float("nan"),
        }


# ---------------------------------------------------------------------------
# Prophesee-style time-windowed evaluation
# (reference src/dagr/utils/coco_eval.py:65-145)
# ---------------------------------------------------------------------------
def match_times(all_ts: np.ndarray, gt_t: np.ndarray, dt_t: np.ndarray,
                time_tol: int):
    """Two-pointer windowing (reference coco_eval.py:110-145): for each
    timestamp, GT boxes at exactly that time and detections within
    ``+-time_tol`` of it. Both time arrays must be sorted ascending.
    Returns parallel lists of (lo, hi) index ranges."""
    gt_size, dt_size = len(gt_t), len(dt_t)
    gt_win, dt_win = [], []
    low_gt = high_gt = low_dt = high_dt = 0
    for ts in all_ts:
        while low_gt < gt_size and gt_t[low_gt] < ts:
            low_gt += 1
        high_gt = max(low_gt, high_gt)
        while high_gt < gt_size and gt_t[high_gt] <= ts:
            high_gt += 1
        lo, hi = ts - time_tol, ts + time_tol
        while low_dt < dt_size and dt_t[low_dt] < lo:
            low_dt += 1
        high_dt = max(low_dt, high_dt)
        while high_dt < dt_size and dt_t[high_dt] <= hi:
            high_dt += 1
        gt_win.append((low_gt, high_gt))
        dt_win.append((low_dt, high_dt))
    return gt_win, dt_win


def evaluate_detection_windowed(gt_list: List[dict], dt_list: List[dict],
                                num_classes: int = 2,
                                time_tol: int = 50_000,
                                iou_thresholds=None) -> Dict[str, float]:
    """Time-windowed mAP (reference evaluate_detection, coco_eval.py:65-95):
    KPIs are computed only at timestamps that carry at least one GT box;
    detections count only within ``time_tol`` microseconds of that
    timestamp. Each ``gt_list``/``dt_list`` entry is one sequence:
    dict('t' [N] sorted us, 'boxes' [N,4] xyxy, 'labels' [N]; detections
    additionally 'scores' [N])."""
    buf = DetectionBuffer(num_classes, iou_thresholds)
    for gt, dt in zip(gt_list, dt_list):
        gt_t = np.asarray(gt["t"])
        dt_t = np.asarray(dt["t"])
        if not (np.all(gt_t[1:] >= gt_t[:-1])
                and np.all(dt_t[1:] >= dt_t[:-1])):
            raise ValueError("ground truth and detections must be sorted "
                             "by time")
        all_ts = np.unique(gt_t)
        gt_win, dt_win = match_times(all_ts, gt_t, dt_t, time_tol)
        for (g0, g1), (d0, d1) in zip(gt_win, dt_win):
            buf.update(
                [{"boxes": np.asarray(dt["boxes"])[d0:d1],
                  "scores": np.asarray(dt["scores"])[d0:d1],
                  "labels": np.asarray(dt["labels"])[d0:d1]}],
                [{"boxes": np.asarray(gt["boxes"])[g0:g1],
                  "labels": np.asarray(gt["labels"])[g0:g1]}])
    return buf.compute()
