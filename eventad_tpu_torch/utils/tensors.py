"""Small constant tensors made once per device."""
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
