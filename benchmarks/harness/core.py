"""What every cell shares: finding a cell's files by name, the cards, the
clock, and the result line.

``BENCHMARK.json`` names each cell's configuration and traffic; the
configuration's file (its ``file``), the mix ``mixes/<traffic>.json`` and
the limits ``limits/<cell>.json`` hold the rest, and the mix's ``loop``
names the loop module under ``loops/``.  A per-layer metric's reader is
``metrics/<metric>.py``.  A later cell adds files and entries; nothing
here names one."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
BENCH = Path(__file__).resolve().parents[1]
# top-level module names the benchmark's process may not hold once its
# window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "eventad_tpu")


@dataclasses.dataclass
class Cell:
    name: str
    config: dict            # the configuration file
    mix: dict               # the traffic mix
    limits: dict            # compared number -> limit
    chips: int
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]   # the per-layer metrics this cell reports


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench_file: Path = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    spec = json.loads((bench_file or ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    cfg = {c["name"]: c for c in spec["configs"]}[w["config"]]
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if _reports(m, name) and m["moves"] in moved]
    return Cell(
        name=name,
        config=json.loads((ROOT / cfg["file"]).read_text()),
        mix=json.loads((BENCH / "mixes" / f"{w['traffic']}.json")
                       .read_text()),
        limits=json.loads((BENCH / "limits" / f"{name}.json").read_text()),
        chips=int(w["chips"]), end_to_end=e2e, per_layer=per_layer)


def reader(metric: str):
    """The ``read(record)`` function of ``metrics/<metric>.py``."""
    path = BENCH / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmarks.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics(cell: Cell, record: dict, trace: bool) -> Dict[str, float]:
    """The cell's end-to-end metrics (``--trace 0``: the record's values
    under their names) or its per-layer metrics (``--trace 1``: each
    reader's number; a reader that finds nothing leaves its metric out)."""
    if not trace:
        return {m["name"]: record[m["name"]] for m in cell.end_to_end}
    out = {}
    for m in cell.per_layer:
        v = reader(m["name"])(record)
        if v is not None:
            out[m["name"]] = v
    return out


def process_start() -> float:
    """This process's start on the wall clock (Linux ``/proc``)."""
    ticks = os.sysconf("SC_CLK_TCK")
    stat = Path("/proc/self/stat").read_text()
    start = int(stat.rsplit(")", 1)[1].split()[19]) / ticks
    for line in Path("/proc/stat").read_text().splitlines():
        if line.startswith("btime "):
            return int(line.split()[1]) + start
    raise RuntimeError("no btime in /proc/stat")


def require_cards(n: int):
    """The CUDA device of a cell that needs ``n`` cards; exits without a
    result where there are fewer."""
    import torch
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: the benchmark measures the card")
    if torch.cuda.device_count() < n:
        sys.exit(f"{torch.cuda.device_count()} CUDA devices, the cell "
                 f"needs {n}")
    return torch.device("cuda:0")


def power_limit_w() -> Optional[float]:
    out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                          "--format=csv,noheader,nounits", "-i", "0"],
                         capture_output=True, text=True)
    try:
        return float(out.stdout.strip().splitlines()[0])
    except (IndexError, ValueError):
        return None


def p95(values) -> float:
    """The 95th percentile of all values (linear interpolation)."""
    v = sorted(values)
    if len(v) == 1:
        return v[0]
    k = 0.95 * (len(v) - 1)
    lo = int(k)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (k - lo)


def spread_line(unit: str, seconds, cpu_share: float = None) -> None:
    """The window's units' times on standard error: count and the 10th,
    50th and 90th percentiles and the largest, ms; with ``cpu_share`` the
    share of the window the timing thread spent on the CPU."""
    q = statistics.quantiles([1e3 * t for t in seconds], n=10) \
        if len(seconds) > 1 else [1e3 * seconds[0]] * 9
    extra = "" if cpu_share is None else f" cpu {cpu_share!r}"
    print(f"window: {len(seconds)} x {unit}, ms p10 {q[0]!r} p50 "
          f"{q[4]!r} p90 {q[8]!r} max {1e3 * max(seconds)!r}{extra}",
          file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Top-level names of ``sys.modules`` that are JAX or the JAX
    package, compared whole."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def finish(cell: Cell, *, correct: bool, attempted: int, failed: int,
           metrics: Dict[str, tuple], device: dict, compared: Dict[str, tuple],
           breakdown: dict = None) -> None:
    """Prints the compared numbers beside their limits on standard error,
    then the result line as the last line of standard output.  Exits
    without a result where JAX or the JAX package is loaded."""
    found = forbidden_modules()
    if found:
        sys.exit(f"the process holds {', '.join(found)}: the benchmark "
                 f"measures the port alone")
    names = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed),
           "metrics": {k: {"value": float(v), "unit": names[k]}
                       for k, v in metrics.items()},
           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["compared"] = {k: {"value": float(v), "limit": float(lim)}
                       for k, (v, lim) in compared.items()}
    print(f"correct: {bool(correct)}", file=sys.stderr)
    for k, (v, lim) in compared.items():
        print(f"compared {k}: {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
