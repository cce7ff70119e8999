"""Checkpointing with the reference's file semantics (counterpart of
``eventad_tpu/utils/checkpoint.py``; reference utils/model.py:101-136).

``latest_checkpoint``, ``best_auc_model`` and ``best_ap_model`` files, each
a ``torch.save`` of ``{"model": ..., "optimizer": ...}`` with a JSON sidecar
``{epoch, best_auc, best_ap}`` beside it.  ``model`` is the whole model in
the reference's state-dict key layout (``models/convert.
export_reference_state``), so the head of a checkpoint written here loads
into the JAX package through its torch converters.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import torch

from ..models.convert import (export_reference_state, load_reference_state,
                              split_reference_state)
from ..models.dagr import EventADModel, resolve_device

SUFFIX = ".pt"


def save_model(path, model: EventADModel, optimizer=None,
               extra: Optional[dict] = None) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    state = {k: torch.from_numpy(v)
             for k, v in export_reference_state(model).items()}
    torch.save({"model": state,
                "optimizer": optimizer.state_dict() if optimizer else None},
               path)
    if extra is not None:
        with open(path.with_suffix(".json"), "w") as f:
            json.dump(extra, f)


def load_checkpoint(path, model: EventADModel, optimizer=None,
                    device=None) -> dict:
    """Restores ``model`` (and ``optimizer``, if given and saved) in place
    from ``path``, onto ``device`` (the CUDA card unless the caller names
    the CPU; the model must already be there).  A tensor whose shape does
    not fit the model raises ``ValueError``.  Returns the extras."""
    dev = resolve_device(device)
    obj = torch.load(Path(path), map_location=dev, weights_only=True)
    dagr_sd, head_sd = split_reference_state(obj["model"])
    load_reference_state(model, dagr_sd, head_sd)
    if optimizer is not None and obj.get("optimizer") is not None:
        optimizer.load_state_dict(obj["optimizer"])
    return load_extra(path)


def load_extra(path) -> dict:
    p = Path(path).with_suffix(".json")
    if p.exists():
        with open(p) as f:
            return json.load(f)
    return {}


def save_checkpoint(model_dir, model: EventADModel, optimizer, epoch: int,
                    best_auc: float, best_ap: float, is_best_auc: bool,
                    is_best_ap: bool) -> None:
    """reference utils/model.py:101-136 file naming."""
    model_dir = Path(model_dir)
    extra = dict(epoch=epoch, best_auc=float(best_auc),
                 best_ap=float(best_ap))
    save_model(model_dir / f"latest_checkpoint{SUFFIX}", model, optimizer,
               extra)
    if is_best_auc:
        save_model(model_dir / f"best_auc_model{SUFFIX}", model, optimizer,
                   extra)
    if is_best_ap:
        save_model(model_dir / f"best_ap_model{SUFFIX}", model, optimizer,
                   extra)


def find_best_checkpoint(output_dir: str, experiment_name: str,
                         explicit: str = "") -> Path:
    """reference utils/utils.py:95-133 search order: explicit path, else the
    newest experiment dir, best_ap -> best_auc -> latest."""
    if explicit:
        return Path(explicit)
    model_dir = Path(output_dir) / "models"
    if not model_dir.exists():
        raise FileNotFoundError(f"Model directory does not exist: {model_dir}")
    exps = sorted(model_dir.glob(f"{experiment_name}_*"), reverse=True)
    if not exps:
        raise FileNotFoundError(
            f"No directories matching experiment name: {experiment_name}")
    latest = exps[0]
    for name in ("best_ap_model", "best_auc_model", "latest_checkpoint"):
        if (latest / (name + SUFFIX)).exists():
            return latest / (name + SUFFIX)
    raise FileNotFoundError(f"No checkpoints in {latest}")
