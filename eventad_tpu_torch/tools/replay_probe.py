"""Is the device time of the captured bf16 forward the same for every capture?

    python3 -m eventad_tpu_torch.tools.replay_probe [captures]

At the reference operating point (batch 6, 360x240, 16 384 events per item,
ResNet-50, bf16, random weights from seed 0) the scoring forward is captured
in a CUDA graph ``captures`` times (default 4), each capture made after the
last one is freed, as ``bench``'s ``scan_device_ms_per_batch`` makes one.
For each capture: the host's time of one ``replay()`` call (median of 20,
the queue idle), the card's milliseconds per replay by the two-length delta
(``utils/devtime.replay_ms``, as ``bench`` times it) and by CUDA events
around 50
replays, and the device time of each kernel in a ``torch.profiler`` trace of
3 replays (``tools/profile_step.traced_kernels``).  Prints the card's name
and power limit, one line per capture, and a JSON line with every
capture's figures and the ten kernels whose time differs most between the
fastest and the slowest capture.  Needs a CUDA device; run it in a process
of its own, since late traces lose device events (``PERF.md`` §6, PRs
1-12: a trace has to be its process's first).
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

from ..config import Config
from ..data.synthetic import make_synthetic_batch
from ..models.dagr import graph_static_config, init_model, model_forward
from ..utils.devtime import capture, replay_ms
from .profile_step import traced_kernels

EVENT_REPLAYS = 50


def replay_figures(graph) -> dict:
    """The figures of one captured graph (see the module docstring)."""
    torch.cuda.synchronize()
    host = []
    for _ in range(20):
        t0 = time.perf_counter()
        graph.replay()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    delta = replay_ms(graph)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(EVENT_REPLAYS):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    kernels = traced_kernels(graph.replay, n_traced=3)
    return dict(host_replay_ms=statistics.median(host),
                delta_ms=delta,
                events_ms=a.elapsed_time(b) / EVENT_REPLAYS,
                traced_ms=sum(k[1] for k in kernels),
                kernels={k[0]: k[1] for k in kernels})


def main(argv=None):
    if not torch.cuda.is_available():
        raise SystemExit("replay_probe: no CUDA device")
    argv = list(argv or [])
    n = int(argv[0]) if argv else 4
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    cfg = Config(batch_size=6, use_image=True, compute_dtype="bfloat16",
                 event_buckets=(16384,))
    model, bc, mc = init_model(cfg, torch.Generator().manual_seed(0), "cuda")
    batch = make_synthetic_batch(cfg, boxes_per_item=6).to("cuda")
    gsc = graph_static_config(cfg)

    def fwd():
        with torch.no_grad():
            return model_forward(model, batch, bc, mc, gsc).logits
    runs = []
    for i in range(n):
        graph, _ = capture(fwd)
        graph.replay()
        fig = replay_figures(graph)
        del graph
        runs.append(fig)
        print(f"capture {i}: host {fig['host_replay_ms']:.4f} ms a replay()"
              f" call; card {fig['delta_ms']:.4f} ms a replay by the delta, "
              f"{fig['events_ms']:.4f} by CUDA events, {fig['traced_ms']:.4f}"
              f" traced", flush=True)
    fast = min(runs, key=lambda r: r["events_ms"])["kernels"]
    slow = max(runs, key=lambda r: r["events_ms"])["kernels"]
    diff = sorted(((slow.get(k, 0.0) - fast.get(k, 0.0), k[:100])
                   for k in set(fast) | set(slow)), reverse=True)[:10]
    print(json.dumps({"card": smi, "captures": [
        {k: v for k, v in r.items() if k != "kernels"} for r in runs],
        "slowest_minus_fastest_ms": [dict(kernel=k, ms=d)
                                     for d, k in diff]}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
