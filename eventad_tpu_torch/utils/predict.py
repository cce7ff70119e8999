"""Prediction collection over a loader (counterpart of
``eventad_tpu/utils/predict.py``; reference utils/test.py:9-180).

Builds: sample-level score/label arrays, ``frame_data[vid][frame]``,
``video_predictions[vid][frame] = max score`` and ``video_first_anomaly``.

Scores are the raw anomaly-class logits (reference utils/test.py:109-111 —
no softmax is applied; thresholds in the TTA/RESPONSE metrics then compare
against logits, preserved as-is).

Note on frame ids: the reference derives frame ids by regexing sample-id
strings that its own data layer never provides, so every frame id collapses
to 0 (utils/test.py:49-52 + utils/utils.py:70-93) — that collapse is what
produced the committed mRESPONSE=1.2017 (= (20+4)/20 + 1/FPS). We default to
*real* frame ids; pass ``legacy_frame_collapse=True`` to reproduce the
reference-as-run behaviour for golden-number parity.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Dict

import numpy as np


def collect_predictions(forward_fn: Callable, loader, *,
                        threshold: float = 0.5,
                        legacy_frame_collapse: bool = False) -> Dict:
    """forward_fn(batch) -> (logits [B,S,2], valid [B,S], labels [B,S])
    as numpy; loader yields (EventBatch, BatchMeta)."""
    all_scores, all_labels, sample_ids = [], [], []
    frame_data: Dict = {}
    video_first_anomaly: Dict = {}
    video_predictions: Dict = {}
    valid_batches = skipped = 0

    for bi, (batch, meta) in enumerate(loader):
        if batch.is_empty():
            skipped += 1
            continue
        logits, valid, labels = forward_fn(batch)
        valid_batches += 1
        for j in range(meta.n_items):
            vid = meta.sequences[j]
            fid = 0 if legacy_frame_collapse else int(meta.frame_ids[j])
            vmask = np.asarray(valid[j])
            if not vmask.any():
                continue
            for s in np.where(vmask)[0]:
                score = float(logits[j, s, 1])
                label = float(labels[j, s])
                all_scores.append(score)
                all_labels.append(label)
                sample_ids.append(f"{vid}_frame_{fid}_obj_{s}")
                fd = frame_data.setdefault(vid, {}).setdefault(
                    fid, {"scores": [], "labels": []})
                fd["scores"].append(score)
                fd["labels"].append(label)
                vp = video_predictions.setdefault(vid, {})
                vp[fid] = max(vp.get(fid, 0.0), score)
                if label > 0.5:
                    if vid not in video_first_anomaly \
                            or fid < video_first_anomaly[vid]:
                        video_first_anomaly[vid] = fid

    if not all_labels:
        raise RuntimeError("No valid predictions or labels collected")
    all_scores = np.array(all_scores)
    all_labels = np.array(all_labels)
    return {
        "all_preds": (all_scores > threshold).astype(np.int64),
        "all_labels": all_labels,
        "all_scores": all_scores,
        "sample_ids": sample_ids,
        "frame_data": frame_data,
        "video_first_anomaly": video_first_anomaly,
        "video_predictions": video_predictions,
        "valid_batch_count": valid_batches,
        "skipped_batch_count": skipped,
    }


def load_toa_values(toa_file: str) -> Dict:
    """reference utils/utils.py:50-68."""
    if not toa_file or not os.path.exists(toa_file):
        return {}
    with open(toa_file) as f:
        return json.load(f)
