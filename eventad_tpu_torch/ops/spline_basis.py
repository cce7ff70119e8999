"""Linear B-spline tap weights and the activation table shared by the spline
convolutions (counterpart of ``eventad_tpu/ops/spline_basis.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

ACTS = {
    None: lambda x: x,
    "relu": torch.relu,
    "elu": lambda x: torch.where(x > 0, x, torch.expm1(x)),
    "hardtanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "silu": F.silu,
}

# activation codes of the CUDA kernels (csrc/common.cuh, enum Act)
ACT_CODES = {None: 0, "relu": 1, "elu": 2, "hardtanh": 3, "silu": 4}


def axis_weights(ux: torch.Tensor, uy: torch.Tensor, ks: int, *,
                 mx0: int = 0, my0: int = 0, nxs: int = None,
                 nys: int = None):
    """Per-axis linear-spline tap weights for pre-scaled attrs
    ``u = attr * (ks-1)``: weight ``1-fr`` on the floor tap and ``fr`` on the
    next, restricted to taps ``[mx0, mx0+nxs) x [my0, my0+nys)``.  Returns
    ``(cxs, cys)``, lists of tensors shaped like ``ux``; the (my, mx) tap
    coefficient is ``cys[my] * cxs[mx]``."""
    nxs = ks if nxs is None else nxs
    nys = ks if nys is None else nys
    ix0 = torch.clamp(torch.floor(ux).to(torch.int32), 0, ks - 2)
    iy0 = torch.clamp(torch.floor(uy).to(torch.int32), 0, ks - 2)
    frx = ux - ix0.to(ux.dtype)
    fry = uy - iy0.to(uy.dtype)
    lx = ix0 - mx0
    ly = iy0 - my0
    zero = torch.zeros((), dtype=ux.dtype, device=ux.device)
    cxs = [torch.where(lx == mx, 1.0 - frx, zero)
           + torch.where(lx == mx - 1, frx, zero) for mx in range(nxs)]
    cys = [torch.where(ly == my, 1.0 - fry, zero)
           + torch.where(ly == my - 1, fry, zero) for my in range(nys)]
    return cxs, cys
