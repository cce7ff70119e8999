"""``device_idle_pct.score``: see ``harness/readers.device_idle_pct``."""
from benchmarks.harness.readers import device_idle_pct as read  # noqa: F401
