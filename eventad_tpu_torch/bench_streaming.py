"""Streaming latency benchmark of the port (counterpart of the root
``bench_streaming.py``).

    python -m eventad_tpu_torch.bench_streaming [n_chunk] [compute_dtype]
        [--device cpu] [--n_buf N] [--iters N] [--<Config field> value]

The root script's operating point: one stream (batch 1), 360x240, ResNet-50
image branch, a ring of ``n_buf`` 16 384 events, chunks of ``n_chunk`` 512,
bf16 frozen features, random weights from seed 0.  Times the incremental
step (``streaming.evaluate.latency_bench_incremental``: step and append
p50, refresh, read, and the ``append_many`` / ``step.many`` loops per
chunk) and the detection read-out (``latency_bench_detect``), and counts
the dense and incremental FLOPs (``flops_report``).  Every time is the
host-clock time of one call ending in a synchronise, the host's share
inside.  On the card, last, ``device_times_incremental`` adds the root
script's ``device_step_ms`` and ``device_append_ms`` (30 calls on chunks
staged on the card, one synchronise, per call), ``device_step_trace_ms``
(one step's device intervals in a profiler trace) and
``dispatch_floor_ms`` (a scalar add's dispatch).  Prints the card's name
and power limit, then one JSON line.
Without a card and without ``--device cpu`` it raises.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from .bench_detector import card_name_and_limit
from .config import parse_args
from .models.dagr import init_model, resolve_device
from .streaming.evaluate import (device_times_incremental, flops_report,
                                 latency_bench_detect,
                                 latency_bench_incremental)

# the root script's device-time keys, measured on the card only
CARD_KEYS = ("device_step_ms", "device_step_trace_ms", "dispatch_floor_ms",
             "device_append_ms")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("n_chunk", nargs="?", type=int, default=512)
    p.add_argument("compute_dtype", nargs="?", default="bfloat16")
    p.add_argument("--device", default=None)
    p.add_argument("--n_buf", type=int, default=16384)
    p.add_argument("--iters", type=int, default=40)
    args, rest = p.parse_known_args(argv)
    dev = resolve_device(args.device)
    card = card_name_and_limit() if dev.type == "cuda" else "cpu"
    print(card, flush=True)
    cfg = parse_args(rest, batch_size=1, event_buckets=(args.n_buf,),
                     compute_dtype=args.compute_dtype)
    model, _, _ = init_model(cfg, torch.Generator().manual_seed(0), dev)
    lat = latency_bench_incremental(model, cfg, n_buf=args.n_buf,
                                    n_chunk=args.n_chunk, iters=args.iters)
    det = latency_bench_detect(cfg, n_buf=args.n_buf, n_chunk=args.n_chunk,
                               iters=args.iters, device=dev)
    # last, so that no host-clock time runs after a profiler trace; the
    # trace is still the process's first, which keeps every device event
    card_times = (device_times_incremental(model, cfg, n_buf=args.n_buf,
                                           n_chunk=args.n_chunk)
                  if dev.type == "cuda" else {})
    fl = flops_report(cfg, n_events=args.n_buf, changed_events=args.n_chunk)
    result = {
        "metric": "streaming_p50_latency_ms",
        "value": lat["p50_ms"],
        "unit": "ms",
        "p99_ms": lat["p99_ms"],
        "append_p50_ms": lat["append_p50_ms"],
        "refresh_ms": lat["refresh_ms"],
        "device_read_ms": lat["device_read_ms"],
        "device_read_detections_ms": det["device_read_detections_ms"],
        "device_append_scan_ms": lat["device_append_scan_ms"],
        "device_step_scan_ms": lat["device_step_scan_ms"],
        **card_times,
        "compute_dtype": args.compute_dtype,
        "events_per_chunk": args.n_chunk,
        "n_buf": args.n_buf,
        "dense_mflops": fl["dense_mflops"],
        "delta_mflops": fl["delta_mflops"],
        "flop_ratio": fl["ratio"],
        "card": card,
    }
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main(sys.argv[1:])
