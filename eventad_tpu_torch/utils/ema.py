"""Exponential moving average of the detector's parameters (counterpart of
``eventad_tpu/utils/ema.py``; reference ``ModelEMA``,
src/dagr/model/networks/ema.py:6-51).

The decay ramps as ``0.9999 * (1 - exp(-n / 2000))``, ``n`` the number of
updates including this one, computed in f32.  Parameters only: the BN
running statistics are not averaged (an evaluation with the EMA weights
reads the live ones).
"""
from __future__ import annotations

import contextlib
from typing import List, NamedTuple

import numpy as np
import torch


class EMAState(NamedTuple):
    params: List[torch.Tensor]   # in the order of the parameters given
    updates: int


def ema_init(params) -> EMAState:
    return EMAState([p.detach().clone() for p in params], 0)


def ema_decay(n: int, decay: float = 0.9999, tau: float = 2000.0) -> float:
    f32 = np.float32
    return float(f32(decay) * (f32(1) - np.exp(-f32(n) / f32(tau))))


def ema_update(state: EMAState, params, decay: float = 0.9999,
               tau: float = 2000.0) -> EMAState:
    """``d * ema + (1 - d) * p`` for every parameter, in place."""
    n = state.updates + 1
    d = ema_decay(n, decay, tau)
    live = [p.detach() for p in params]
    torch._foreach_mul_(state.params, d)
    torch._foreach_add_(state.params, live,
                        alpha=float(np.float32(1) - np.float32(d)))
    return EMAState(state.params, n)


@contextlib.contextmanager
def ema_weights(params, state: EMAState):
    """Within the block ``params`` hold the EMA weights; the live ones are
    put back after it."""
    params = list(params)
    with torch.no_grad():
        live = [p.detach().clone() for p in params]
        for p, e in zip(params, state.params):
            p.copy_(e)
    try:
        yield
    finally:
        with torch.no_grad():
            for p, v in zip(params, live):
                p.copy_(v)
