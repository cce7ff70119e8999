"""The kernel flavours of the bf16 scoring forward against the f32 run
(counterpart of the root ``tools/check_fused.py``).

    python -m eventad_tpu_torch.tools.check_fused [n_events]

Runs ``model_forward`` at the reference operating point (batch 6, 360x240,
ResNet-50, random weights from seed 0) in f32 and in five bf16 flavours:

  base       level 0 and the pooled levels through the generic conv K5
  two_block  level 0 through K2, pooled levels through K5
  shift      level 0 through K5, pooled levels through K3
  default    K2 + K3 + K4, the default flags
  bilinear   the default with the image rows from the sampler K7

and prints each flavour's largest logit error relative to the f32 run's
scale.  All five are bf16 programs that round at different points; none
should stand out: the exit code is nonzero if one lies beyond
``max(1.5 * base, 2e-2)``.  ``--device cpu`` runs the plain versions.
"""
from __future__ import annotations

import argparse
import sys

import torch

from ..config import Config
from ..data.synthetic import make_synthetic_batch
from ..models.dagr import (graph_static_config, init_model, model_forward,
                           resolve_device)

FLAVOURS = {
    "base": dict(fused_two_block=False, fused_shift=False),
    "two_block": dict(fused_two_block=True, fused_shift=False),
    "shift": dict(fused_two_block=False, fused_shift=True),
    "default": {},
    "bilinear": dict(bilinear_kernel=True),
}


def flavour_errors(cfg: Config, device) -> dict:
    """Each flavour's max logit error against f32, relative to f32's
    scale."""
    model, bc, mc = init_model(cfg, torch.Generator().manual_seed(0), device)
    gsc = graph_static_config(cfg)
    batch = make_synthetic_batch(cfg, boxes_per_item=6).to(device)

    def run(bc_):
        return model_forward(model, batch, bc_, mc, gsc).logits.double()

    f32 = run(bc._replace(compute_dtype="float32"))
    scale = float(f32.abs().max()) + 1e-9
    bf16 = bc._replace(compute_dtype="bfloat16")
    return {name: float((run(bf16._replace(**flags)) - f32).abs().max())
            / scale for name, flags in FLAVOURS.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n_events", nargs="?", type=int, default=16384)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"device: {torch.cuda.get_device_name(0) if dev.type == 'cuda' else dev}")
    cfg = Config(batch_size=6, use_image=True, compute_dtype="bfloat16",
                 event_buckets=(args.n_events,))
    rel = flavour_errors(cfg, dev)
    for name, r in rel.items():
        print(f"{name:>10}: rel vs f32 = {r:.3e}")
    band = max(1.5 * rel["base"], 2e-2)
    bad = [n for n, r in rel.items() if r > band]
    print("OK" if not bad
          else f"FAIL: {bad} diverge beyond the bf16 band {band:.3e}")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
