"""Does a ``torch.profiler`` trace keep every device event, late in a process?

    python -m eventad_tpu_torch.tools.trace_probe [seconds_between_rounds]

Traces five small kernels at a time, twenty traces in a row, then keeps the
card busy for some seconds (default 20) and does the same again, three
rounds in all, and prints how many of the five device events each trace
holds.  On the H100 machine the port is measured on, the first seconds of
tracing keep all five and later traces lose the first events of each burst
(4 of 5, then 2 of 5): a time or a count read from a trace is to be taken
early in a process, from the first traces it opens, and checked for
completeness.  ``chip_smoke.py`` therefore times kernels by CUDA events
around a CUDA-graph replay and opens one trace only, early.
"""
from __future__ import annotations

import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

BURST = 5


def device_events(fn) -> int:
    """Number of device events in a trace of ``fn()``."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(str(e.device_type).endswith("CUDA") for e in prof.events())


def main(argv=None):
    wait_s = float((argv or ["20"])[0])
    x = torch.randn(1 << 20, device="cuda")

    def burst():
        for _ in range(BURST):
            x.mul_(1.0)

    t0 = time.perf_counter()
    for _ in range(3):
        at = time.perf_counter() - t0
        counts = [device_events(burst) for _ in range(20)]
        print(f"{at:6.1f} s after the first trace: device events per trace "
              f"({BURST} expected) {counts}", flush=True)
        until = time.perf_counter() + wait_s
        while time.perf_counter() < until:
            x.mul_(1.0)
            torch.cuda.synchronize()


if __name__ == "__main__":
    main(sys.argv[1:])
