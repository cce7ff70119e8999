"""Model-axis parameter sharding of the detector (counterpart of
``eventad_tpu/parallel/sharding.py``).

The rule is the JAX package's: every weight of at least ``min_size``
elements is split over the mesh's "model" axis along its widest divisible
dimension, the last winning ties, in the JAX layout (conv kernels HWIO,
spline kernels ``[K, Cin, Cout]``, linears ``[Cin, Cout]``), which shards
channel-out.  The port keeps conv kernels OIHW, so the rule is read on the
reference layout through ``models.convert.detector_layout_axes`` and
mapped back to the port's dimension.

Where XLA chooses per op between tensor-parallel compute and gathering a
weight just before use, this module always gathers (FSDP style): the ranks
of a model group hold a shard of each sharded weight, its optimizer
moments and its EMA; at the start of a step the shards are all-gathered
into the module's parameters, so the spline and kernel ops read whole
weights; after the backward the whole gradients are summed over the data
group (each data rank's loss is its part of the global loss) and each rank
keeps its shard's slice.  Collectives are explicit rather than FSDP2's:
its gradient averaging divides by the world size, and its reduce-scatter
over the shard group would sum the model ranks' gradients, which here come
from the same items and must be counted once.
"""
from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist
from torch import nn

from ..models.convert import detector_layout_axes


def model_axis_spec(shape, axis_size: int, *, min_size: int = 8192):
    """The dimension of ``shape`` to shard over a model axis of
    ``axis_size`` ranks, or None (replicated): the widest divisible
    dimension, the last winning ties; None for leaves under ``min_size``
    elements, an axis of 1, or no divisible dimension."""
    size = 1
    for d in shape:
        size *= d
    if size < min_size or axis_size <= 1:
        return None
    best = None
    for i, d in enumerate(shape):
        if d % axis_size == 0 and (best is None or d >= shape[best]):
            best = i
    return best


def param_shardings(module: nn.Module, axis_size: int, *,
                    min_size: int = 8192) -> List[Optional[int]]:
    """For every parameter of the detector ``module`` (in
    ``module.parameters()`` order), the port's dimension that
    :func:`model_axis_spec` picks on the reference layout, or None."""
    axes = detector_layout_axes(module)
    dims = []
    for p in module.parameters():
        ax = axes[p]
        j = model_axis_spec([p.shape[a] for a in ax], axis_size,
                            min_size=min_size)
        dims.append(None if j is None else ax[j])
    return dims


class ShardedParams:
    """The parameters of ``module`` over the "model" axis of ``mesh``:
    ``locals`` are what the optimizer and the EMA hold (this rank's shard
    of a sharded weight, the module's own parameter otherwise); ``dims``
    the sharded dimensions (None: replicated)."""

    def __init__(self, module: nn.Module, mesh, *, min_size: int = 8192):
        self.params = list(module.parameters())
        self.model_group = mesh.get_group("model")
        self.data_group = mesh.get_group("data")
        self.m = mesh["model"].size()
        self.rank = mesh.get_local_rank("model")
        self.dims = param_shardings(module, self.m, min_size=min_size)
        self.locals = [
            p if d is None else nn.Parameter(self.shard(p.detach(), d))
            for p, d in zip(self.params, self.dims)]

    @property
    def n_sharded(self) -> int:
        return sum(d is not None for d in self.dims)

    def shard(self, full: torch.Tensor, dim: int) -> torch.Tensor:
        n = full.shape[dim] // self.m
        return full.narrow(dim, self.rank * n, n).contiguous().clone()

    def full(self, t: torch.Tensor, dim: Optional[int]) -> torch.Tensor:
        """The whole tensor of which ``t`` is this rank's shard along
        ``dim`` (``t`` itself where ``dim`` is None)."""
        if dim is None:
            return t
        parts = [torch.empty_like(t) for _ in range(self.m)]
        dist.all_gather(parts, t.detach().contiguous(),
                        group=self.model_group)
        return torch.cat(parts, dim)

    def gather(self, values: List[torch.Tensor] = None) -> None:
        """Writes the whole weights into the module's parameters, from
        ``locals`` or from per-parameter shards ``values`` (the EMA's)."""
        values = self.locals if values is None else values
        with torch.no_grad():
            for p, v, d in zip(self.params, values, self.dims):
                if d is not None or v is not p:
                    p.copy_(self.full(v, d))

    def full_values(self, values: List[torch.Tensor]) -> List[torch.Tensor]:
        """Whole tensors of per-parameter shards ``values``."""
        return [self.full(v, d) for v, d in zip(values, self.dims)]

    def reduce_grads(self) -> None:
        """Sums the module's gradients over the data group (in one flat
        buffer) and leaves each shard its slice as ``.grad``; a parameter
        the loss does not reach counts as a zero gradient."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.data_group)
        off = 0
        for p, loc, d in zip(self.params, self.locals, self.dims):
            g = flat[off:off + p.numel()].view_as(p)
            off += p.numel()
            if d is None:
                p.grad = g.clone()
            else:
                loc.grad = self.shard(g, d)
                p.grad = None

    def grad_norm(self, grads: List[torch.Tensor]) -> torch.Tensor:
        """The global norm of the whole gradients from ``grads``, the
        gradients of ``locals``: the replicated ones counted once, the
        shards' squares summed over the model group."""
        rep = [g for g, d in zip(grads, self.dims) if d is None]
        sh = [g for g, d in zip(grads, self.dims) if d is not None]
        zero = grads[0].new_zeros(())

        def sq(gs):
            return (torch.stack(torch._foreach_norm(gs)).square().sum()
                    if gs else zero)
        sq_sh = sq(sh)
        dist.all_reduce(sq_sh, group=self.model_group)
        return torch.sqrt(sq(rep) + sq_sh)

    def full_optimizer_state(self, optimizer) -> dict:
        """``optimizer.state_dict()`` with every shard-shaped state tensor
        (the moments) gathered whole: the state of an optimizer over the
        module's parameters.  Every rank of the model group must call it."""
        sd = dict(optimizer.state_dict())   # its entries are the live ones

        def whole(i, k, v):
            d = self.dims[i]
            if (d is not None and torch.is_tensor(v)
                    and v.shape == self.locals[i].shape):
                return self.full(v, d)
            return v
        sd["state"] = {i: {k: whole(i, k, v) for k, v in st.items()}
                       for i, st in sd["state"].items()}
        return sd


def shard_params(module: nn.Module, mesh, *,
                 min_size: int = 8192) -> ShardedParams:
    """``module``'s parameters sharded over the mesh's "model" axis and
    replicated over "data"; the module keeps whole copies, written by
    ``ShardedParams.gather``."""
    return ShardedParams(module, mesh, min_size=min_size)


def sharded_init(init_fn, sharded: Optional[ShardedParams], params=None):
    """``init_fn`` (an optimizer's or the EMA's) over the shards, so its
    state has the parameters' sharding; over ``params`` without a
    mesh."""
    return init_fn(params if sharded is None else sharded.locals)
