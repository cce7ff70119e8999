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
import torch.distributed as dist

from ..models.dagr import EventADModel, box_inputs, resolve_device
from ..models.eventad import eventad_forward
from .mesh import data_rank, gather_items


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


class ClippedOptimizer:
    """Global-norm clipping followed by a torch optimizer ``inner``: optax's
    ``chain(clip_by_global_norm(clip), ...)``.  The clip scales every
    gradient by ``clip / max(norm, clip)`` (torch's ``clip_grad_norm_``
    divides by ``norm + 1e-6`` instead), the norm taken over every
    parameter.  A parameter the loss does not reach gets a zero gradient
    first, so its moments decay and its weight decay applies as optax's do
    (a torch optimizer skips a parameter without ``.grad``).  With a
    ``schedule`` (a function of the update count) the rate is set from the
    number of updates made before each one, as optax evaluates its schedule
    (the first update at 0).  ``grad_norm`` (a function of the gradients)
    takes the norm's place where the parameters are shards of larger ones
    (``parallel.sharding.ShardedParams.grad_norm``)."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 inner: torch.optim.Optimizer, clip: float,
                 schedule: Callable[[int], float] = None,
                 grad_norm: Callable[[list], torch.Tensor] = None):
        self.params = list(params)
        self.clip = float(clip)
        self.inner = inner
        self.schedule = schedule
        self.grad_norm = grad_norm
        self.count = 0

    def step(self) -> None:
        """One update from the gradients in ``p.grad``."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        if self.grad_norm is not None:
            norm = self.grad_norm(grads)
        else:
            norm = torch.linalg.vector_norm(torch.stack(
                torch._foreach_norm(grads)))
        torch._foreach_mul_(grads, self.clip / torch.clamp(norm,
                                                           min=self.clip))
        if self.schedule is not None:
            set_lr(self, self.schedule(self.count))
        self.inner.step()
        self.count += 1

    def zero_grad(self) -> None:
        self.inner.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        """The inner optimizer's state dict with the update count beside
        its keys."""
        return {**self.inner.state_dict(), "count": self.count}

    def load_state_dict(self, sd: dict) -> None:
        sd = dict(sd)
        self.count = int(sd.pop("count", 0))
        self.inner.load_state_dict(sd)


class HeadOptimizer(ClippedOptimizer):
    """The chain of the reference's ``make_optimizer``: the global-norm clip,
    then ``torch.optim.AdamW`` with optax's constants written out (betas 0.9
    / 0.999, eps 1e-8 outside the root, decoupled decay)."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 learning_rate: float, weight_decay: float,
                 grad_clip: float):
        params = list(params)
        super().__init__(params, torch.optim.AdamW(
            params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
            weight_decay=weight_decay), grad_clip)


def make_optimizer(params, learning_rate: float, weight_decay: float,
                   grad_clip: float) -> HeadOptimizer:
    """``params``: the trained parameters, ``model.head.parameters()``."""
    return HeadOptimizer(params, learning_rate, weight_decay, grad_clip)


def set_lr(optimizer: ClippedOptimizer, lr: float) -> ClippedOptimizer:
    for group in optimizer.inner.param_groups:
        group["lr"] = float(lr)
    return optimizer


class TrainStepFns(NamedTuple):
    train_step: Callable
    eval_step: Callable


def make_train_fns(model: EventADModel, bc, mc, gsc,
                   optimizer: HeadOptimizer, device=None,
                   mesh=None) -> TrainStepFns:
    """Builds the train and eval steps of ``model`` on ``device`` (the CUDA
    card unless the caller names the CPU; the model must already be there).
    Batches are moved to the device by the steps.

    ``train_step(batch, generator=None) -> dict(loss, n_valid, finite)``:
    forward in training mode (dropout seeded by ``generator``, off without
    one), backward through the head, then the optimizer step unless the
    loss or a gradient is non-finite (the head and the optimizer state are
    then left as they were; ``finite`` is read on the host once per step).

    ``eval_step(batch) -> (logits, valid, labels, loss, n_valid)``.

    With a ``mesh`` (``parallel.mesh.make_mesh``) the steps are data
    parallel over its "data" axis, as the JAX package's sharded step: each
    rank passes its block of the batch (``parallel.mesh.shard_batch``) and
    runs the frozen feature path on it; the box features are gathered into
    item order, since the head's track state flows from item to item, and
    every rank runs the head over the whole batch (its dropout draws those
    of one process from the same generator) with the loss of its own items.
    The head's gradients are summed over the data group (the loss is a sum
    over boxes) and the clip and the update follow on every rank, or are
    skipped on every rank where the summed loss or a summed gradient is
    non-finite.  ``loss`` and ``n_valid`` are the batch's; the eval step
    returns the whole batch's outputs on every rank."""
    dev = resolve_device(device)
    for p in model.parameters():
        if p.device.type != dev.type:
            raise ValueError(f"the model is on {p.device}, the steps were "
                             f"asked for {dev}")
    head_params = list(model.head.parameters())
    group = None if mesh is None else mesh.get_group("data")

    def forward(batch, training, generator=None):
        batch = batch.to(dev)
        b = batch.pos.shape[0]
        feats, coords = box_inputs(model.dagr, batch,
                                   bc._replace(batch_size=b), gsc)
        parts = (feats, coords, batch.box_present[:, 1], batch.box_labels)
        own = slice(None)
        if group is not None:
            parts = [gather_items(t, group) for t in parts]
            if training:
                own = slice(data_rank(mesh) * b, (data_rank(mesh) + 1) * b)
        with torch.set_grad_enabled(training):
            return eventad_forward(model.head, mc, *parts, training=training,
                                   generator=generator, loss_items=own)

    def train_step(batch, generator: torch.Generator = None) -> dict:
        optimizer.zero_grad()
        out = forward(batch, True, generator)
        out.loss.backward()
        for p in head_params:
            # a parameter the loss does not reach (the attention weights
            # of a one-item batch) still takes its weight decay
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        loss = out.loss.detach()
        if group is not None:
            # one sum over the data group for the gradients and the loss;
            # the finite flag then reads the same numbers on every rank
            flat = torch.cat([p.grad.reshape(-1) for p in head_params]
                             + [loss.reshape(1)])
            dist.all_reduce(flat, group=group)
            off = 0
            for p in head_params:
                p.grad = flat[off:off + p.numel()].view_as(p)
                off += p.numel()
            loss = flat[-1]
        flags = [torch.isfinite(loss)] + [
            torch.isfinite(p.grad).all() for p in head_params]
        finite = bool(torch.stack(flags).all())
        if finite:
            optimizer.step()
        return dict(loss=loss, n_valid=out.n_valid, finite=finite)

    def eval_step(batch):
        out = forward(batch, False)
        return out.logits, out.valid, out.labels, out.loss, out.n_valid

    return TrainStepFns(train_step, eval_step)
