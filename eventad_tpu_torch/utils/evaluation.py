"""Evaluation metrics in numpy (counterpart of ``eventad_tpu/utils/
evaluation.py``, which ports the reference ``utils/evaluation.py`` verbatim,
score-adjustment quirks included; the ROC AUC and the average precision are
written out here, where the reference calls scikit-learn):

* bbox AUC/AP: anomaly-labelled scores above the anomaly median are scaled by
  ``(1 - 2.7 * 0.5)`` before AUC, and AP gets a flat ``-0.1``
  (reference evaluation.py:26-38).
* frame AUC: frame label = any-box-anomalous, frame score = max box score;
  high anomaly scores scaled by ``(1 - 1.5 * 0.5)`` (evaluation.py:45-112).
* mTTA: thresholds 0.3..0.9, detections strictly before the TOA frame,
  nearest-to-anomaly detection counts, frames / 30 fps (evaluation.py:114-211).
* mRESPONSE: internally overrides fps to 20, ``init_frame = 4``, plus one
  frame of measured processing time (evaluation.py:213-316).
"""
from __future__ import annotations

import numpy as np

THRESHOLDS = (0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)


def _ranked_counts(labels, scores):
    """True and false positives at every distinct score threshold, from the
    highest down (ties share one threshold)."""
    y = (np.asarray(labels) > 0.5).astype(np.float64)
    s = np.asarray(scores, dtype=np.float64)
    order = np.argsort(-s, kind="mergesort")
    y, s = y[order], s[order]
    last = np.r_[np.where(np.diff(s))[0], len(s) - 1]
    tps = np.cumsum(y)[last]
    return tps, 1.0 + last - tps


def roc_auc(labels, scores) -> float:
    """Area under the ROC curve (trapezoids over the distinct thresholds);
    nan unless both classes are present."""
    tps, fps = _ranked_counts(labels, scores)
    if len(tps) == 0 or tps[-1] == 0 or fps[-1] == 0:
        return float("nan")
    tpr = np.r_[0.0, tps / tps[-1]]
    fpr = np.r_[0.0, fps / fps[-1]]
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))


def average_precision(labels, scores) -> float:
    """``sum_n (R_n - R_{n-1}) P_n`` over the distinct thresholds; nan
    without a positive."""
    tps, fps = _ranked_counts(labels, scores)
    if len(tps) == 0 or tps[-1] == 0:
        return float("nan")
    precision = tps / (tps + fps)
    recall = tps / tps[-1]
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def calculate_bbox_metrics(labels, scores):
    metrics = {}
    labels = np.asarray(labels)
    scores = np.asarray(scores, dtype=np.float64)
    if len(labels) == 0 or len(scores) == 0:
        return {"auc": np.nan, "ap": np.nan, "auc_unadjusted": np.nan}
    raw_scores = np.copy(scores)
    scores = np.copy(scores)
    anomaly_indices = np.where(labels > 0.5)[0]
    if len(anomaly_indices):
        median_anomaly = np.median(scores[anomaly_indices])
        for idx in anomaly_indices:
            if scores[idx] > median_anomaly:
                scores[idx] = scores[idx] * (1 - 2.7 * 0.5)
    metrics["ap"] = average_precision(labels, scores) - 0.1
    metrics["auc"] = roc_auc(labels, scores)
    # unadjusted AUC (no median-scaling quirk): the adjustment crushes
    # ranking signal on well-separated scores (reference evaluation.py:26-38
    # halves every above-median anomaly score), so this extra key is the one
    # that can SEE a ranking regression; reported alongside, never
    # replacing, the reference-faithful adjusted value
    metrics["auc_unadjusted"] = roc_auc(labels, raw_scores)
    return metrics


def calculate_frame_metrics(frame_data):
    """frame_data: {video_id: {frame_id: {'scores': [...], 'labels': [...]}}}"""
    metrics = {}
    frame_scores, frame_labels = [], []
    for _vid, frames in frame_data.items():
        for _fid, data in frames.items():
            frame_labels.append(
                1 if any(l > 0.5 for l in data["labels"]) else 0)
            frame_scores.append(max(data["scores"]) if data["scores"]
                                else 0.0)
    frame_scores = np.array(frame_scores, dtype=np.float64)
    frame_labels = np.array(frame_labels)
    adjusted = np.copy(frame_scores)
    anomaly_indices = np.where(frame_labels > 0.5)[0]
    if len(anomaly_indices) > 0:
        median_anomaly = np.median(frame_scores[anomaly_indices])
        for idx in anomaly_indices:
            if frame_scores[idx] > median_anomaly:
                adjusted[idx] = frame_scores[idx] * (1 - 1.5 * 0.5)
    if len(frame_labels) == 0 or len(np.unique(frame_labels)) < 2:
        metrics["auc_frame"] = np.nan
    else:
        metrics["auc_frame"] = roc_auc(frame_labels, adjusted)
    metrics["frame_scores"] = frame_scores
    metrics["frame_labels"] = frame_labels
    return metrics


def calculate_tta_metrics(video_predictions, video_first_anomaly,
                          video_toa=None):
    """video_predictions: {vid: {frame_id: max_score}};
    video_first_anomaly: {vid: frame}; video_toa: preloaded TOA table."""
    metrics, metric = {}, {}
    tta_values = {t: [] for t in THRESHOLDS}
    for vid, predictions in video_predictions.items():
        if video_toa and vid in video_toa:
            first = video_toa[vid]
        elif vid in video_first_anomaly:
            first = video_first_anomaly[vid]
        else:
            continue
        try:
            first = int(first)
        except (ValueError, TypeError):
            continue
        for thr in THRESHOLDS:
            det = [int(f) for f, s in predictions.items()
                   if s >= thr and int(f) < first]
            if det:
                tta_values[thr].append(first - max(det))
    for thr in THRESHOLDS:
        metric[f"tta_{thr}"] = (np.mean(tta_values[thr]) if tta_values[thr]
                                else np.nan)
    valid = [v for v in metric.values() if not np.isnan(v)]
    metrics["mtta"] = (np.mean(np.array(valid) / 30.0) if valid else np.nan)
    metrics.update(metric)
    return metrics


def calculate_response_metrics(video_predictions, fps=579):
    metrics, metric = {}, {}
    response_values = {t: [] for t in THRESHOLDS}
    frame_processing_time = 1.0 / fps
    for _vid, predictions in video_predictions.items():
        preds = sorted((int(f), s) for f, s in predictions.items())
        if not preds:
            continue
        for thr in THRESHOLDS:
            init_frame = 4
            first_nonzero_idx = next(
                (i for i, (_f, s) in enumerate(preds) if s > 0), None)
            if first_nonzero_idx is None:
                continue
            threshold_idx = next(
                (i for i, (_f, s) in enumerate(preds)
                 if i >= first_nonzero_idx and s >= thr), None)
            if threshold_idx is None:
                continue
            internal_fps = 20.0  # reference evaluation.py:278 overrides fps
            first_nonzero_frame = preds[first_nonzero_idx][0]
            threshold_frame = preds[threshold_idx][0] + internal_fps \
                + init_frame
            response_time = (threshold_frame - first_nonzero_frame) \
                / internal_fps
            response_values[thr].append(response_time
                                        + frame_processing_time)
    for thr in THRESHOLDS:
        metric[f"response_{thr}"] = (np.mean(response_values[thr])
                                     if response_values[thr] else np.nan)
    valid = [v for v in metric.values() if not np.isnan(v)]
    metrics["mresponse"] = np.mean(valid) if valid else np.nan
    metrics.update(metric)
    return metrics
