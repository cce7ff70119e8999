"""Train/eval steps of the anomaly head + optimizer with reduce-on-plateau
(counterpart of ``eventad_tpu/parallel/train_step.py``; reference
utils/train.py:27-53,141-152).

AdamW(lr, weight_decay) with gradient clipping by global norm and
ReduceLROnPlateau(factor, patience) on the validation loss.  Only the
anomaly head trains; DAGR is frozen (EventAD.py:149-150), so the optimizer
holds ``model.head``'s parameters alone.  The reference's NaN/Inf checks
become a ``finite`` flag returned from the step: a non-finite loss or
gradient skips the update.
"""
from __future__ import annotations

from typing import Callable, Iterable, NamedTuple

import torch

from ..models.dagr import EventADModel, model_forward, resolve_device


class PlateauState(NamedTuple):
    best: float
    bad_epochs: int
    scale: float


def plateau_init() -> PlateauState:
    return PlateauState(best=float("inf"), bad_epochs=0, scale=1.0)


def plateau_update(st: PlateauState, val_loss: float, *, factor: float = 0.5,
                   patience: int = 5) -> PlateauState:
    """torch ReduceLROnPlateau(mode='min') semantics (threshold 1e-4 rel)."""
    if val_loss < st.best * (1 - 1e-4):
        return PlateauState(val_loss, 0, st.scale)
    bad = st.bad_epochs + 1
    if bad > patience:
        return PlateauState(st.best, 0, st.scale * factor)
    return PlateauState(st.best, bad, st.scale)


class HeadOptimizer:
    """Global-norm clipping followed by AdamW, the chain of the reference's
    ``make_optimizer``.  The clip scales every gradient by
    ``clip / max(norm, clip)`` (optax ``clip_by_global_norm``; torch's
    ``clip_grad_norm_`` divides by ``norm + 1e-6`` instead).  AdamW is
    ``torch.optim.AdamW`` with optax's constants written out (betas 0.9 /
    0.999, eps 1e-8 outside the root, decoupled decay)."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 learning_rate: float, weight_decay: float,
                 grad_clip: float):
        self.params = list(params)
        self.grad_clip = float(grad_clip)
        self.adamw = torch.optim.AdamW(
            self.params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay)

    def step(self) -> None:
        """One update from the gradients in ``p.grad``."""
        grads = [p.grad for p in self.params]
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        scale = self.grad_clip / torch.clamp(norm, min=self.grad_clip)
        for g in grads:
            g.mul_(scale)
        self.adamw.step()

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return self.adamw.state_dict()

    def load_state_dict(self, sd: dict) -> None:
        self.adamw.load_state_dict(sd)


def make_optimizer(params, learning_rate: float, weight_decay: float,
                   grad_clip: float) -> HeadOptimizer:
    """``params``: the trained parameters, ``model.head.parameters()``."""
    return HeadOptimizer(params, learning_rate, weight_decay, grad_clip)


def set_lr(optimizer: HeadOptimizer, lr: float) -> HeadOptimizer:
    for group in optimizer.adamw.param_groups:
        group["lr"] = float(lr)
    return optimizer


class TrainStepFns(NamedTuple):
    train_step: Callable
    eval_step: Callable


def make_train_fns(model: EventADModel, bc, mc, gsc,
                   optimizer: HeadOptimizer, device=None) -> TrainStepFns:
    """Builds the train and eval steps of ``model`` on ``device`` (the CUDA
    card unless the caller names the CPU; the model must already be there).
    Batches are moved to the device by the steps.

    ``train_step(batch, generator=None) -> dict(loss, n_valid, finite)``:
    forward in training mode (dropout seeded by ``generator``, off without
    one), backward through the head, then the optimizer step unless the
    loss or a gradient is non-finite (the head and the optimizer state are
    then left as they were; ``finite`` is read on the host once per step).

    ``eval_step(batch) -> (logits, valid, labels, loss, n_valid)``."""
    dev = resolve_device(device)
    for p in model.parameters():
        if p.device.type != dev.type:
            raise ValueError(f"the model is on {p.device}, the steps were "
                             f"asked for {dev}")
    head_params = list(model.head.parameters())

    def train_step(batch, generator: torch.Generator = None) -> dict:
        optimizer.zero_grad()
        out = model_forward(model, batch.to(dev), bc, mc, gsc, training=True,
                            generator=generator)
        out.loss.backward()
        for p in head_params:
            # a parameter the loss does not reach (the attention weights
            # of a one-item batch) still takes its weight decay
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        flags = [torch.isfinite(out.loss)] + [
            torch.isfinite(p.grad).all() for p in head_params]
        finite = bool(torch.stack(flags).all())
        if finite:
            optimizer.step()
        return dict(loss=out.loss.detach(), n_valid=out.n_valid,
                    finite=finite)

    def eval_step(batch):
        out = model_forward(model, batch.to(dev), bc, mc, gsc)
        return out.logits, out.valid, out.labels, out.loss, out.n_valid

    return TrainStepFns(train_step, eval_step)
