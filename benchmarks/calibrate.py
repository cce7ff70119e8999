"""Readings that set a cell's limits: for each seed, a short window of the
cell's own loop at its own sizes, then the numbers that decide ``correct``
for the program and for the control (the reference computed in the
nearest precision below the configuration's, put in the program's place);
with ``--fault``, for the program with that fault planted
(``benchmarks/faults.py``).  Not run by the benchmark's own runs.

    python -m benchmarks.calibrate --workload <cell> --seeds 1,2,3 \\
        [--seconds 3] [--fault <name>]

Prints one JSON line a seed: ``{"seed", "program", "control", ...}``."""
from __future__ import annotations

import argparse
import contextlib
import importlib
import json

from . import faults
from .harness import core


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    cell = core.load_cell(args.workload)
    dev = core.require_cards(cell.chips)
    kind = cell.mix["loop"]
    loop = importlib.import_module(f"benchmarks.loops.{kind}")
    for seed in (int(s) for s in args.seeds.split(",")):
        with (getattr(faults, kind)(args.fault) if args.fault
              else contextlib.nullcontext()):
            out = loop.calibrate(cell, seed, args.seconds, dev)
        print(json.dumps(dict(seed=seed, fault=args.fault, **out)),
              flush=True)


if __name__ == "__main__":
    main()
