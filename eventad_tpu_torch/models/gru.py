"""Multi-layer GRU with torch.nn.GRU gate semantics, one step over all track
slots at once (counterpart of ``eventad_tpu/models/gru.py``; reference
models/EventAD.py:62-97).

    r = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
    z = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
    n = tanh(x W_in + b_in + r * (h W_hn + b_hn))
    h' = (1 - z) * n + z * h

Weights are kept ``[In, 3H]`` / ``[H, 3H]`` (gate blocks r, z, n along the
last axis), the JAX package's layout.
"""
from __future__ import annotations

import torch
from torch import nn


class GRULayer(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int,
                 generator: torch.Generator = None):
        super().__init__()
        # reference init: kaiming-normal W_ih (fan_in = In), orthogonal W_hh
        # per gate block, zero biases (EventAD.py:68-74)
        std = (2.0 / input_dim) ** 0.5
        self.w_ih = nn.Parameter(
            torch.randn(input_dim, 3 * hidden_dim, generator=generator) * std)
        self.w_hh = nn.Parameter(torch.cat(
            [nn.init.orthogonal_(torch.empty(hidden_dim, hidden_dim),
                                 generator=generator) for _ in range(3)], 1))
        self.b_ih = nn.Parameter(torch.zeros(3 * hidden_dim))
        self.b_hh = nn.Parameter(torch.zeros(3 * hidden_dim))


class GRU(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, n_layers: int,
                 generator: torch.Generator = None):
        super().__init__()
        self.layers = nn.ModuleList(
            [GRULayer(input_dim if i == 0 else hidden_dim, hidden_dim,
                      generator) for i in range(n_layers)])


def dropout_mask(x: torch.Tensor, rate: float,
                 generator: torch.Generator) -> torch.Tensor:
    """Inverted dropout with the keep mask drawn from ``generator`` (which
    lives on ``x``'s device): kept values are scaled by ``1 / (1 - rate)``."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def gru_step(gru: GRU, x: torch.Tensor, h: torch.Tensor, *,
             dropout: float = 0.0, generator: torch.Generator = None):
    """One step: ``x [B, In]``, ``h [B, L, H]`` -> ``(out [B, H], h' [B, L,
    H])``.  ``dropout`` is the inter-layer rate (applied to every layer's
    output but the last, as torch.nn.GRU), active only with a
    ``generator``; the returned hidden states are the undropped ones."""
    hs = []
    inp = x
    last = len(gru.layers) - 1
    for i, p in enumerate(gru.layers):
        gi = inp @ p.w_ih + p.b_ih
        gh = h[:, i, :] @ p.w_hh + p.b_hh
        ir, iz, inn = gi.chunk(3, dim=-1)
        hr, hz, hn = gh.chunk(3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(inn + r * hn)
        inp = (1.0 - z) * n + z * h[:, i, :]
        hs.append(inp)
        if dropout > 0.0 and generator is not None and i < last:
            inp = dropout_mask(inp, dropout, generator)
    return inp, torch.stack(hs, dim=1)
