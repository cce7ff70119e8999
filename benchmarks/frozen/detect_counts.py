"""Frozen counts of the streaming detector's chunk: the incremental
backbone's FLOPs (``counts.backbone_flops``, as the anomaly stream counts
them), the GNN head's on the level-3 and level-4 cell grids (every cell a
node with the 25 slots of its 5 x 5 neighbourhood, as the pooled levels'
spline convs are counted) and the decode's.  The CNN head runs once a
frame, at set-up, and is not counted; NMS compares and counts no FLOPs."""
from __future__ import annotations

from .counts import backbone_flops, spline_conv_flops

SLOTS = (2 * 2 + 1) ** 2
# per anchor: x and y (add the cell, times the stride), w and h (exp,
# times the stride), a sigmoid for objectness and each class
DECODE_PER_ANCHOR = 4 + 4


def gnn_head_flops(geo, head) -> float:
    """FLOPs of the GNN head's scales at batch 1: stem, the two conv
    blocks, the three predictions."""
    ch = geo.channels()
    cins = (ch[-2], ch[-1])[:head.num_scales]
    width = max(cins)
    total = 0.0
    for (nx, ny), cin in zip(geo.grid_dims()[2:4], cins):
        nodes = nx * ny
        convs = [(cin, width), (width, width), (width, width),
                 (width, head.num_classes), (width, 4), (width, 1)]
        for c_in, c_out in convs:
            total += spline_conv_flops(nodes * SLOTS, c_in, c_out,
                                       geo.kernel_size, n_nodes=nodes)
    return total


def decode_flops(geo, head) -> float:
    anchors = sum(nx * ny for nx, ny in geo.grid_dims()[2:4])
    return anchors * (DECODE_PER_ANCHOR + 1 + head.num_classes)


def chunk_flops(geo, ring: int, chunk: int, head) -> float:
    """FLOPs of one detection step: an append of ``chunk`` events into a
    ring of ``ring`` and a read."""
    return (backbone_flops(geo, ring, streaming_changed=chunk)
            + gnn_head_flops(geo, head) + decode_flops(geo, head))
