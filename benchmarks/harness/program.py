"""The program side of every loop: the port's ``Config`` of a cell, the
TF32 policy, the device record, and the order of a run (set-up, window,
traced segment, the program freed, the comparison, the result line)."""
from __future__ import annotations

import time

from . import core


def program_config(cell, dtype_key: str = "features"):
    """The port's ``Config`` of the cell: its fields and the compute dtype
    the configuration states for ``dtype_key``."""
    from eventad_tpu_torch.config import Config
    f = dict(cell.config["fields"])
    f["event_buckets"] = tuple(f["event_buckets"])
    return Config(**f).replace(compute_dtype=cell.config["dtypes"][dtype_key])


def set_precision(cell) -> None:
    """The configuration's TF32 policy for every f32 product of the
    process (the program's and the reference's)."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = bool(cell.config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cell.config["tf32"])


def device_record(dev) -> dict:
    """``device`` of the result line, the peak read now."""
    import torch
    on_card = dev.type == "cuda"
    return {"platform": "gpu" if on_card else "cpu",
            "kind": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "count": 1,
            "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(dev))
                                  if on_card else 0),
            "power_limit_w": core.power_limit_w() if on_card else None}


def drive(cell, session, seconds: float, trace: bool, t_start: float,
          judge) -> None:
    """One run of a built ``session`` (its set-up done): the window, with
    ``trace`` the traced segment of ``mix["trace_units"]`` units, the
    program freed, then ``judge(session, records) -> (failed, {name:
    number})``, each number held to ``cell.limits[name]``, and the result
    line."""
    setup_s = time.time() - t_start
    record = session.window(seconds)
    record["setup_s"] = setup_s
    device = device_record(session.dev)
    breakdown = None
    if trace:
        red = session.traced(cell.mix["trace_units"])
        record["trace"] = red
        device.update(busy_s=red["busy_s"], window_s=red["window_s"])
        breakdown = red["breakdown"]
        for k, v in red["kernels"].items():
            print(f"{k}_roofline {v['roofline_pct']!r} % (traced "
                  f"{v['traced_s']!r} s, bound {v['bound_s']!r} s)",
                  flush=True)
    session.close()
    failed, numbers = judge(session, record["records"])
    compared = {k: (v, cell.limits[k]) for k, v in numbers.items()}
    core.finish(cell, correct=failed == 0 and all(
                    v <= lim for v, lim in compared.values()),
                attempted=len(record["records"]), failed=failed,
                metrics=core.metrics(cell, record, trace), device=device,
                compared=compared, breakdown=breakdown)
