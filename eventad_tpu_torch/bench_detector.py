"""Detector throughput at the reference operating point on one GPU
(counterpart of the root ``bench_detector.py``).

    python -m eventad_tpu_torch.bench_detector [n_events] [compute_dtype]

The full detection forward (event graph -> CNN + GNN backbone -> hybrid
YOLOX head -> decode -> class-offset NMS) in eval mode at batch 6 on one
synthetic batch: 1 + 5 warm-up forwards, then 20 timed with one synchronise
at the end.  Prints the card's name and power limit, then one JSON line
(images/s, batch ms).  ``--device cpu`` runs it on the CPU; without a card
and without that flag it raises.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import torch

from .config import Config
from .data.synthetic import make_synthetic_batch
from .models.dagr import resolve_device
from .models.detector import detector_forward, init_detector

WARMUP, ITERS = 1 + 5, 20


def card_name_and_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def bench(detector, batch, cfg, bc, *, warmup: int = WARMUP,
          iters: int = ITERS) -> float:
    """Seconds per detection forward: ``warmup`` forwards, then ``iters``
    timed ones with one synchronise at the end."""
    sync = torch.cuda.synchronize if batch.pos.is_cuda else (lambda: None)
    for _ in range(warmup):
        detector_forward(detector, batch, cfg, bc)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        detector_forward(detector, batch, cfg, bc)
    sync()
    return (time.perf_counter() - t0) / iters


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n_events", nargs="?", type=int, default=16384)
    p.add_argument("compute_dtype", nargs="?", default="bfloat16")
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_name_and_limit() if dev.type == "cuda" else "cpu"
    print(card, flush=True)
    cfg = Config(batch_size=6, use_image=True,
                 compute_dtype=args.compute_dtype,
                 event_buckets=(args.n_events,))
    detector, bc = init_detector(cfg, torch.Generator().manual_seed(0), dev)
    batch = make_synthetic_batch(cfg, boxes_per_item=6).to(dev)
    dt = bench(detector, batch, cfg, bc)
    result = {
        "metric": "detector_images_per_sec",
        "value": round(cfg.batch_size / dt, 2),
        "unit": "images/s",
        "batch_ms": round(dt * 1e3, 2),
        "events_per_item": args.n_events,
        "compute_dtype": args.compute_dtype,
        "card": card,
    }
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
