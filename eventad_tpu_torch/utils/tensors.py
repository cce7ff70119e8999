"""Small constant tensors made once per device; tensors kept on a module."""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, dtype: torch.dtype, device: str) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def constant(values, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.tensor(values, dtype=dtype, device=device)``, made at the
    first call for these values and this device and the same tensor after,
    so a forward copies nothing to the card for it.  Read it, never write
    it.  Dividing by such a tensor, not by Python numbers, keeps the
    quotient exact (PyTorch divides by a Python number as a product with
    its reciprocal)."""
    return _constant(tuple(values), dtype, str(device))


def kept_on(module: torch.nn.Module, name: str, sources, make, key=()):
    """``make()`` (run without autograd), kept on ``module`` under ``name``
    while ``key`` is equal and every tensor ``make`` reads (``sources``,
    held with the result so that no other tensor takes one's id) has the
    same id, storage and ``_version``: an in-place update makes it anew; a
    write through ``tensor.data`` is not seen."""
    k = tuple(key) + tuple((id(t), t._version, t.data_ptr())
                           for t in sources)
    kept = module.__dict__.get(name)
    if kept is None or kept[0] != k:
        with torch.no_grad():
            kept = (k, make(), tuple(sources))
        module.__dict__[name] = kept
    return kept[1]


def frozen_operands(module: torch.nn.Module, name: str, sources, make,
                    key=()):
    """:func:`kept_on` of operands prepared from frozen weights, unless
    autograd has to reach the weights (gradients on, a source that requires
    them): a kept result carries no graph, so then ``make()`` runs anew,
    recorded, as it would inline.  The same values either way."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in sources):
        return make()
    return kept_on(module, name, sources, make, key)
