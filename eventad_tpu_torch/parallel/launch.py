"""Runs one function on ``world`` processes joined by a ``FileStore``
rendezvous: the multi-process runs of ``tools/extract_sp``,
``tools/dryrun_multichip`` and the tests, without ``torchrun`` and without
a TCP port.

    results = spawn("eventad_tpu_torch.tools.dryrun_multichip:dp_train",
                    world=2, kwargs=dict(seed=0))

Each child is ``python -m eventad_tpu_torch.parallel.launch``: it joins the
group (gloo on the CPU with one intra-op thread, NCCL on ``cuda:{rank}``),
calls ``target(**kwargs)``, saves what it returns to ``rank{r}.pt`` and
leaves the group.  ``spawn`` waits for every child and returns the ranks'
results in rank order; a child that fails, or a run over ``timeout``
seconds, stops them all and raises with the failed child's output.
"""
from __future__ import annotations

import argparse
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

_ROOT = Path(__file__).resolve().parents[2]


def spawn(target: str, world: int, *, kwargs: dict = None,
          device: str = "cpu", timeout: float = 600.0) -> list:
    """``target`` is ``"module:function"``; ``kwargs`` must be JSON."""
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        store = work / "store"
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=os.pathsep.join(
                       [str(_ROOT)] + [p for p in os.environ.get(
                           "PYTHONPATH", "").split(os.pathsep) if p]))
        procs, logs = [], []
        for r in range(world):
            log = open(work / f"rank{r}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "eventad_tpu_torch.parallel.launch",
                 target, str(r), str(world), str(store), device,
                 json.dumps(kwargs or {}), str(work)],
                stdout=log, stderr=subprocess.STDOUT, env=env))
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                failed = [r for r, p in enumerate(procs)
                          if p.poll() not in (None, 0)]
                if failed or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            for log in logs:
                log.close()
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            r = bad[0]
            tail = (work / f"rank{r}.log").read_text()[-4000:]
            raise RuntimeError(f"{target}: rank {r} of {world} ended with "
                               f"{procs[r].returncode}:\n{tail}")
        return [torch.load(work / f"rank{r}.pt", weights_only=False)
                for r in range(world)]


def _child(argv):
    from .mesh import init_distributed
    import torch.distributed as dist
    p = argparse.ArgumentParser()
    for name in ("target", "rank", "world", "store", "device", "kwargs",
                 "out"):
        p.add_argument(name)
    a = p.parse_args(argv)
    rank, world = int(a.rank), int(a.world)
    if a.device == "cpu":
        torch.set_num_threads(1)
    init_distributed(a.device if a.device == "cpu" else f"cuda:{rank}",
                     store_path=a.store, rank=rank, world_size=world)
    try:
        mod, fn = a.target.split(":")
        result = getattr(importlib.import_module(mod), fn)(
            **json.loads(a.kwargs))
        torch.save(result, Path(a.out) / f"rank{rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _child(sys.argv[1:])
