"""The plain reference of the anomaly head's training step: the frozen
features of a batch (``model.score``'s path, f32, no gradient), the head
over the batch's items in training mode (dropout after the event GRU's
first layer and before the last fusion layer, its keep masks drawn from a
generator in that order), the summed cross entropy of the valid slots,
its gradients by autograd, the global-norm clip and AdamW (decoupled
decay), written out."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .geometry import Geometry
from .model import (box_features, cnn_features, empty_state, gnn, head_step,
                    level0_graph)

BETAS = (0.9, 0.999)
EPS = 1e-8


def is_head(key: str) -> bool:
    return not key.startswith("dagr_model.")


def features(sd, batch: dict, geo: Geometry):
    """``(feats [B, 2, S, C], coords [B, S, 4], present [B, S], labels [B,
    S])`` of a collated batch (tensors on the weights' device)."""
    with torch.no_grad():
        g0 = level0_graph(batch, geo)
        maps = cnn_features(sd, batch["image"], geo) if geo.use_image \
            else None
        _, out4 = gnn(sd, g0, maps, geo)
        bf = box_features(out4, batch["boxes"], batch["box_present"], geo)
        wh = torch.tensor((geo.model_width, geo.model_height,
                           geo.model_width, geo.model_height),
                          dtype=torch.float32, device=bf.device)
        return (bf, batch["boxes"][:, 1] / wh, batch["box_present"][:, 1],
                batch["box_labels"])


def loss(params, geo: Geometry, feats, coords, present, labels, gen,
         rate: float = 0.3):
    """The summed cross entropy of the valid slots over the batch's items
    (the track state flowing from item to item), dropout from ``gen``."""
    def drop(v):
        keep = torch.rand(v.shape, generator=gen, device=v.device) >= rate
        return torch.where(keep, v / (1.0 - rate), 0.0)
    s1 = feats.shape[2]
    slot = torch.arange(s1, device=feats.device)
    valid = (present & (feats[:, 1].abs().sum(-1) > 0)
             & ((slot >= 1) & (slot <= geo.max_boxes))[None, :])
    state = empty_state(geo, feats.device)
    total = 0.0
    for i in range(feats.shape[0]):
        logits, state = head_step(params, geo, feats[i, 1], coords[i],
                                  valid[i], state, drop)
        ce = -F.log_softmax(logits, dim=-1).gather(
            1, labels[i][:, None].long())[:, 0]
        total = total + torch.where(valid[i], ce, 0.0).sum()
    return total


class AdamW:
    """Global-norm clip, then AdamW with decoupled weight decay, on a dict
    of leaves."""

    def __init__(self, params: dict, lr: float, weight_decay: float,
                 clip: float):
        self.params, self.lr, self.wd, self.clip = params, lr, weight_decay, clip
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    def step(self, grads: dict) -> dict:
        """One update; returns the clipped gradients it applied."""
        norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
        scale = self.clip / torch.clamp(norm, min=self.clip)
        self.t += 1
        b1, b2 = BETAS
        clipped = {}
        with torch.no_grad():
            for k, p in self.params.items():
                g = grads[k] * scale
                clipped[k] = g
                self.m[k] = b1 * self.m[k] + (1 - b1) * g
                self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
                mh = self.m[k] / (1 - b1 ** self.t)
                vh = self.v[k] / (1 - b2 ** self.t)
                p.mul_(1 - self.lr * self.wd)
                p.sub_(self.lr * mh / (torch.sqrt(vh) + EPS))
        return clipped


def train(sd, geo: Geometry, batches, seed_gen, lr: float,
          weight_decay: float, clip: float):
    """The head trained from ``sd`` over ``batches`` (collated, on the
    device), one step each; returns ``(losses, first clipped gradients,
    head leaves after the steps)``."""
    params = {k: v.detach().clone().requires_grad_(True)
              for k, v in sd.items() if is_head(k)}
    frozen = {k: v for k, v in sd.items() if not is_head(k)}
    opt = AdamW(params, lr, weight_decay, clip)
    losses, first = [], None
    for batch in batches:
        f = features(frozen, batch, geo)
        lv = loss({**frozen, **params}, geo, *f, seed_gen)
        grads = torch.autograd.grad(lv, list(params.values()),
                                    allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(p))
                 for (k, p), g in zip(params.items(), grads)}
        clipped = opt.step(grads)
        if first is None:
            first = clipped
        losses.append(float(lv.detach()))
    return losses, first, {k: v.detach() for k, v in params.items()}
