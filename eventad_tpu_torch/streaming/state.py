"""Streaming (sliding-window) inference state (counterpart of
``eventad_tpu/streaming/state.py``; reference ``SlidingWindowGraph`` and the
asynchronous layer converters, src/dagr/graph/ev_graph.py:106-166,
src/dagr/asynchronous/).

A fixed-size event ring buffer (slot reuse instead of index re-basing), the
cached CNN pyramid (the image changes at frame rate, events at event rate)
and the persistent GRU hidden states, all tensors of one named tuple.  The
step functions (``runner.py``, ``incremental.py``) return a new state and
never write into the one they were given.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.dagr import resolve_device


class StreamingState(NamedTuple):
    # event ring buffer (chronological: oldest first, newest at the end)
    pos: torch.Tensor        # [N_buf, 3] int32 (x, y, t_us absolute)
    polarity: torch.Tensor   # [N_buf] float32
    valid: torch.Tensor      # [N_buf] bool
    # cached CNN pyramid (updated only when a new image arrives)
    image_feats: Optional[tuple]   # 5 NHWC maps with B=1, or None
    # persistent recurrent head state (per track slot)
    h_event: torch.Tensor    # [S+1, L_e, h_dim]
    h_coord: torch.Tensor    # [S+1, L_c, coord_dim]
    seen: torch.Tensor       # [S+1] bool
    t_now: torch.Tensor      # scalar int32, latest event time


def init_streaming_state(n_buf: int, max_boxes: int, h_dim: int = 256,
                         coord_dim: int = 32, event_layers: int = 2,
                         coord_layers: int = 1,
                         device=None) -> StreamingState:
    """An empty ring of ``n_buf`` events on ``device`` (the CUDA card unless
    the caller names the CPU)."""
    dev = resolve_device(device)
    s1 = max_boxes + 1
    return StreamingState(
        pos=torch.zeros((n_buf, 3), dtype=torch.int32, device=dev),
        polarity=torch.zeros((n_buf,), device=dev),
        valid=torch.zeros((n_buf,), dtype=torch.bool, device=dev),
        image_feats=None,
        h_event=torch.zeros((s1, event_layers, h_dim), device=dev),
        h_coord=torch.zeros((s1, coord_layers, coord_dim), device=dev),
        seen=torch.zeros((s1,), dtype=torch.bool, device=dev),
        t_now=torch.zeros((), dtype=torch.int32, device=dev))
