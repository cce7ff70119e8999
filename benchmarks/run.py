"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python -m benchmarks.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Runs on the CUDA card it is started on and measures ``eventad_tpu_torch``
alone (nothing of JAX or of the JAX package is imported).  Prints, as the
last line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (``--trace 0``: the cell's end-to-end metrics;
``--trace 1``: its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``compared``, each number that decides ``correct``
beside its limit (also the last lines of standard error).  Exits non-zero
without a result where the card is missing or JAX is loaded."""
from __future__ import annotations

import argparse
import importlib

from .harness import core


def main(argv=None) -> None:
    t_start = core.process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = core.load_cell(args.workload)
    dev = core.require_cards(cell.chips)
    loop = importlib.import_module(f"benchmarks.loops.{cell.mix['loop']}")
    loop.run(cell, args.seed, args.seconds, bool(args.trace), dev, t_start)


if __name__ == "__main__":
    main()
