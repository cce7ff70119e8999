"""Per-bounding-box feature pooling from the out4 node table (counterpart of
``eventad_tpu/models/feature_extract.py``; reference EventAD.py:335-499).

Per box, in priority order (EventAD.py:456-499):
1. distance-weighted mean (weights ``1/(d+1e-6)``) of nodes inside the box;
2. else mean of the <= 5 nearest nodes of the same batch item;
3. else the batch item's global mean feature.
"""
from __future__ import annotations

import torch

from .graph import Graph


def extract_box_features(out4: Graph, boxes: torch.Tensor,
                         box_present: torch.Tensor, batch_size: int,
                         width: int, height: int) -> torch.Tensor:
    """``boxes [B, 2, S, 4]`` xywh pixels -> ``[B, 2, S, C]`` f32 features
    (slot = track id; frame axis 0 previous, 1 current).  The kNN mean runs
    in the node dtype, the other reductions in f32, as in the reference."""
    x = out4.x
    dt = x.dtype
    posn = out4.pos[:, :2]
    nmask = out4.node_mask
    nbatch = out4.batch.long()
    m, c = x.shape
    b, nf, s, _ = boxes.shape
    dev = x.device
    xm = torch.where(nmask[:, None], x, torch.zeros((), dtype=dt, device=dev))

    f32 = torch.float32
    gsum = torch.zeros((batch_size, c), dtype=f32, device=dev) \
        .index_add_(0, nbatch, xm.to(f32))
    gcnt = torch.zeros((batch_size,), dtype=f32, device=dev) \
        .index_add_(0, nbatch, nmask.to(f32))
    gfeat = gsum / gcnt.clamp(min=1.0)[:, None]
    has_nodes = gcnt > 0

    x1 = boxes[..., 0] / width
    y1 = boxes[..., 1] / height
    x2 = (boxes[..., 0] + boxes[..., 2]) / width
    y2 = (boxes[..., 1] + boxes[..., 3]) / height
    bx1, by1, bx2, by2 = (v.reshape(-1) for v in (x1, y1, x2, y2))
    bcx = (0.5 * (x1 + x2)).reshape(-1)
    bcy = (0.5 * (y1 + y2)).reshape(-1)
    bb = torch.arange(b, device=dev)[:, None, None].expand(b, nf, s) \
        .reshape(-1)

    px = posn[None, :, 0]
    py = posn[None, :, 1]
    same_b = (nbatch[None, :] == bb[:, None]) & nmask[None, :]
    in_box = (same_b & (px >= bx1[:, None]) & (px <= bx2[:, None])
              & (py >= by1[:, None]) & (py <= by2[:, None]))
    d = torch.sqrt((px - bcx[:, None]) ** 2 + (py - bcy[:, None]) ** 2)

    # 1. distance-weighted in-box mean
    w_in = torch.where(in_box, 1.0 / (d + 1e-6), 0.0)
    w_in = w_in / w_in.sum(dim=1, keepdim=True).clamp(min=1e-30)
    feat_in = w_in @ xm.to(f32)
    any_in = in_box.any(dim=1)

    # 2. kNN-5 among same-item nodes; the stable sort keeps the lower node
    # index first at equal distance, as lax.top_k does
    d_knn = torch.where(same_b, d, torch.inf)
    srt = torch.sort(d_knn, dim=1, stable=True)
    idx5 = srt.indices[:, :5]
    ok5 = torch.isfinite(srt.values[:, :5])
    cnt5 = ok5.sum(dim=1, keepdim=True).clamp(min=1)
    feat_knn = (x[idx5] * ok5[..., None]).sum(dim=1) / cnt5

    feat = torch.where(any_in[:, None], feat_in,
                       torch.where(has_nodes[bb][:, None], feat_knn.to(f32),
                                   gfeat[bb]))
    feat = feat.reshape(b, nf, s, c)
    return torch.where(box_present[..., None], feat,
                       torch.zeros((), dtype=feat.dtype, device=dev))
