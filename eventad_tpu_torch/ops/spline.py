"""Degree-1 open B-spline basis (counterpart of ``eventad_tpu/ops/spline.py``).

For 2-D pseudo-coordinates in [0, 1] and kernel size K per dim, each edge
activates at most 4 kernel slots; flat index ``x + y * K`` (x fastest)."""
from __future__ import annotations

import torch


def spline_basis(attr: torch.Tensor, kernel_size: int):
    """``attr [..., 2]`` -> ``(w [..., 4], idx [..., 4])`` with flat kernel
    indices in ``[0, kernel_size**2)``."""
    k = kernel_size
    u = torch.clamp(attr, 0.0, 1.0) * (k - 1)
    lo = torch.floor(u)
    fr = u - lo
    lo = lo.to(torch.int64)
    ws, idxs = [], []
    for b0 in (0, 1):
        for b1 in (0, 1):
            ws.append((fr[..., 0] if b0 else 1.0 - fr[..., 0])
                      * (fr[..., 1] if b1 else 1.0 - fr[..., 1]))
            i0 = torch.clamp(lo[..., 0] + b0, 0, k - 1)
            i1 = torch.clamp(lo[..., 1] + b1, 0, k - 1)
            idxs.append(i0 + i1 * k)
    return torch.stack(ws, -1), torch.stack(idxs, -1)
