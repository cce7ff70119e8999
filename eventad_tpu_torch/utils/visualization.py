"""Validation + ROC/PR curve plots (counterpart of
``eventad_tpu/utils/visualization.py``; reference
utils/visualization.py:9-139).  The AUC and AP are the port's numpy ones
(``utils/evaluation``); ``matplotlib`` is imported only to plot."""
from __future__ import annotations

import os
from typing import Callable

import numpy as np

from .evaluation import _ranked_counts, average_precision, roc_auc


def validate_and_visualize(eval_step: Callable, loader, result_dir: str,
                           epoch: int, *, plot: bool = True):
    """``eval_step(batch) -> (logits, valid, labels, loss, n_valid)``
    (tensors, as ``make_train_fns`` gives it) over every batch of
    ``loader`` that holds a box.  Returns ``(val_loss, roc_auc, ap)``: the
    summed loss per valid box, and the unadjusted AUC / AP of the anomaly
    logit (nan unless both classes occur); with ``plot``, the ROC and PR
    curves of the epoch go to ``result_dir``."""
    scores, labels = [], []
    total_loss, total_n = 0.0, 0
    for batch, _meta in loader:
        if batch.is_empty():
            continue
        logits, valid, labs, loss, n_valid = eval_step(batch)
        v = valid.cpu().numpy()
        scores.append(logits[..., 1].cpu().numpy()[v])
        labels.append(labs.cpu().numpy()[v])
        total_loss += float(loss)
        total_n += int(n_valid)
    if not scores or total_n == 0:
        raise RuntimeError("validation produced no valid boxes")
    scores, labels = np.concatenate(scores), np.concatenate(labels)
    val_loss = total_loss / total_n
    if len(np.unique(labels)) < 2:
        return val_loss, float("nan"), float("nan")
    auc, ap = roc_auc(labels, scores), average_precision(labels, scores)
    if plot:
        _save_plots(result_dir, epoch, labels, scores, auc, ap)
    return val_loss, auc, ap


def _save_plots(result_dir, epoch, labels, scores, auc, ap):
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    tps, fps = _ranked_counts(labels, scores)
    tpr, fpr = np.r_[0.0, tps / tps[-1]], np.r_[0.0, fps / fps[-1]]
    os.makedirs(result_dir, exist_ok=True)
    fig, ax = plt.subplots()
    ax.plot(fpr, tpr, label=f"AUC = {auc:.4f}")
    ax.plot([0, 1], [0, 1], "k--")
    ax.set_xlabel("False positive rate")
    ax.set_ylabel("True positive rate")
    ax.legend()
    fig.savefig(os.path.join(result_dir, f"roc_curve_epoch_{epoch}.png"))
    plt.close(fig)

    fig, ax = plt.subplots()
    ax.plot(np.r_[0.0, tps / tps[-1]], np.r_[1.0, tps / (tps + fps)],
            label=f"AP = {ap:.4f}")
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.legend()
    fig.savefig(os.path.join(result_dir, f"pr_curve_epoch_{epoch}.png"))
    plt.close(fig)
