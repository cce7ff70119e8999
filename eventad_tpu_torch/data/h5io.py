"""Event HDF5 IO with a millisecond index (counterpart of
``eventad_tpu/data/h5io.py``; the same file format).

``events_2x.h5`` holds ``events/{x,y,t,p}``, ``ms_to_idx`` and ``t_offset``
(reference ``scripts/downsample_events.py:44-92`` writer,
``src/dagr/data/dsec_utils.py:80-120`` reader), compressed with gzip.
``h5py`` is imported only where a file is written or opened.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict

import numpy as np


def create_ms_to_idx(t_us: np.ndarray) -> np.ndarray:
    """``ms_to_idx[ms]`` = first event index with ``t >= ms * 1000``
    (reference downsample_events.py:36-42 semantics via searchsorted)."""
    if len(t_us) == 0:
        return np.zeros((1,), dtype=np.uint64)
    ms_max = int(t_us[-1] // 1000) + 2
    ms = np.arange(ms_max, dtype=np.int64) * 1000
    return np.searchsorted(t_us, ms, side="left").astype(np.uint64)


def write_events(path: Path, events: Dict[str, np.ndarray],
                 t_offset: int = 0):
    """events: dict with x, y (uint16), t (int64 us, sorted), p (uint8)."""
    import h5py
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    t = np.asarray(events["t"], dtype=np.int64)
    if not (np.diff(t) >= 0).all():
        raise ValueError("event timestamps must be sorted")
    with h5py.File(path, "w") as f:
        g = f.create_group("events")
        g.create_dataset("x", data=np.asarray(events["x"], np.uint16),
                         compression="gzip")
        g.create_dataset("y", data=np.asarray(events["y"], np.uint16),
                         compression="gzip")
        g.create_dataset("t", data=t, compression="gzip")
        g.create_dataset("p", data=np.asarray(events["p"], np.uint8),
                         compression="gzip")
        f.create_dataset("ms_to_idx", data=create_ms_to_idx(t),
                         compression="gzip")
        f.create_dataset("t_offset", data=np.int64(t_offset))


class EventFile:
    """Windowed reader (reference ``_load_events`` dsec_utils.py:80-120):
    candidate range from ``ms_to_idx`` (floor/ceil ms), then an exact mask
    on the microsecond timestamps.  The file opens on first use; a pickled
    ``EventFile`` carries only its path, so each loader process opens its
    own handle."""

    def __init__(self, path: Path):
        self.path = Path(path)
        self._f = None

    @property
    def f(self):
        if self._f is None:
            import h5py
            self._f = h5py.File(self.path, "r")
        return self._f

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None

    def __getstate__(self):
        # h5py handles cannot cross processes
        return {"path": self.path, "_f": None}

    @property
    def t_offset(self) -> int:
        return int(self.f["t_offset"][()]) if "t_offset" in self.f else 0

    @property
    def n_events(self) -> int:
        return self.f["events/t"].shape[0]

    def read_all(self) -> Dict[str, np.ndarray]:
        """Every event of the file, as stored."""
        return {k: self.f[f"events/{k}"][:] for k in "xytp"}

    def load_window(self, t0_us: int, t1_us: int) -> Dict[str, np.ndarray]:
        """Events with ``t0 <= t < t1`` (times relative to t_offset)."""
        f = self.f
        ms_to_idx = f["ms_to_idx"]
        n_ms = ms_to_idx.shape[0]
        ms0 = min(max(int(t0_us // 1000), 0), n_ms - 1)
        ms1 = min(max(int(-(-t1_us // 1000)) + 1, 0), n_ms - 1)
        i0 = int(ms_to_idx[ms0])
        i1 = int(ms_to_idx[ms1]) if ms1 > ms0 else self.n_events
        if ms1 >= n_ms - 1:
            i1 = self.n_events
        t = f["events/t"][i0:i1]
        mask = (t >= t0_us) & (t < t1_us)
        out = {"t": t[mask].astype(np.int64)}
        for k in ("x", "y", "p"):
            out[k] = f[f"events/{k}"][i0:i1][mask]
        return out
