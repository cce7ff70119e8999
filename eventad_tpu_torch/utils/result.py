"""Result files: CSV + metrics summary (counterpart of
``eventad_tpu/utils/result.py``: the same directory names, CSV rows and
summary text; reference utils/result.py:5-114).

The reference summary prints frame-AUC as N/A due to a wrong dict key
(result.py:94, SURVEY.md 7.5) — fixed here (documented divergence)."""
from __future__ import annotations

import csv
import os
import time

import numpy as np


def setup_directories(base_dir, experiment_name, mode="train"):
    timestamp = time.strftime("%Y%m%d_%H%M%S")
    if mode == "train":
        result_dir = os.path.join(base_dir, "results",
                                  f"{experiment_name}_{timestamp}")
        model_dir = os.path.join(base_dir, "models",
                                 f"{experiment_name}_{timestamp}")
        os.makedirs(result_dir, exist_ok=True)
        os.makedirs(model_dir, exist_ok=True)
        return {"result_dir": result_dir, "model_dir": model_dir,
                "timestamp": timestamp}
    result_dir = os.path.join(base_dir, "test_results",
                              f"{experiment_name}_{timestamp}")
    os.makedirs(result_dir, exist_ok=True)
    return {"result_dir": result_dir, "timestamp": timestamp}


def _fmt(v):
    try:
        return "N/A" if v is None or np.isnan(v) else f"{v:.4f}"
    except TypeError:
        return "N/A"


def setup_result_file(result_dir, cfg, checkpoint_info=None):
    name = "test_results.csv" if checkpoint_info else "training_results.csv"
    result_file = os.path.join(result_dir, name)
    with open(result_file, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["Experiment", cfg.experiment_name])
        w.writerow(["Dataset", cfg.dataset_directory])
        w.writerow(["Model Parameters",
                    f"x_dim: {cfg.x_dim}, h_dim: {cfg.h_dim}"])
        if checkpoint_info:
            w.writerow(["Checkpoint", checkpoint_info.get("path", "")])
            w.writerow(["Epoch", checkpoint_info.get("epoch", "")])
        else:
            w.writerow(["Epoch", "Train Loss", "Val Loss", "ROC AUC", "AP",
                        "Learning Rate"])
    return result_file


def append_epoch_row(result_file, epoch, train_loss, val_loss, roc_auc, ap,
                     lr):
    with open(result_file, "a", newline="") as f:
        csv.writer(f).writerow([epoch, train_loss, val_loss, roc_auc, ap, lr])


def save_metrics(result_file, bbox_metrics, frame_metrics, tta_metrics=None,
                 response_metrics=None):
    with open(result_file, "a", newline="") as f:
        w = csv.writer(f)
        w.writerow(["AUC", _fmt(bbox_metrics.get("auc"))])
        w.writerow(["AP", _fmt(bbox_metrics.get("ap"))])
        w.writerow(["AUC-Frame", _fmt(frame_metrics.get("auc_frame"))])
        if tta_metrics:
            w.writerow(["mTTA", _fmt(tta_metrics.get("mtta"))])
        if response_metrics:
            w.writerow(["mRESPONSE", _fmt(response_metrics.get("mresponse"))])


def append_fps(result_file, fps):
    with open(result_file, "a", newline="") as f:
        csv.writer(f).writerow(["FPS (frames/second)", f"{fps:.2f}"])


def create_metrics_summary(result_dir, cfg, bbox_metrics, frame_metrics,
                           tta_metrics=None, response_metrics=None,
                           checkpoint_info=None, fps_results=None):
    summary_file = os.path.join(result_dir, "metrics_summary.txt")
    with open(summary_file, "w") as f:
        f.write(f"Experiment: {cfg.experiment_name}\n")
        f.write(f"Dataset: {cfg.dataset_directory}\n")
        if checkpoint_info:
            f.write(f"Checkpoint: "
                    f"{os.path.basename(str(checkpoint_info.get('path', '')))}"
                    f"\n\n")
        f.write("Main Metrics:\n")
        f.write(f"AUC: {_fmt(bbox_metrics.get('auc'))}\n")
        f.write(f"AP: {_fmt(bbox_metrics.get('ap'))}\n")
        f.write(f"AUC-Frame: {_fmt(frame_metrics.get('auc_frame'))}\n")
        if tta_metrics:
            f.write(f"mTTA: {_fmt(tta_metrics.get('mtta'))}\n")
        if response_metrics:
            f.write(f"mRESPONSE: {_fmt(response_metrics.get('mresponse'))}\n")
        if fps_results:
            f.write("\nFPS Measurement:\n")
            f.write(f"FPS: {fps_results['fps']:.2f} \n")
    print("\n==== Main Metrics Summary ====")
    print(f"AUC: {_fmt(bbox_metrics.get('auc'))}")
    print(f"AP: {_fmt(bbox_metrics.get('ap'))}")
    print(f"AUC-Frame: {_fmt(frame_metrics.get('auc_frame'))}")
    if fps_results:
        print(f"FPS: {fps_results['fps']:.2f}")
    if tta_metrics:
        print(f"mTTA: {_fmt(tta_metrics.get('mtta'))}")
    if response_metrics:
        print(f"mRESPONSE: {_fmt(response_metrics.get('mresponse'))}")
    print("========================")
    return summary_file
