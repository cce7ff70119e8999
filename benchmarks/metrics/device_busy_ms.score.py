"""``device_busy_ms.score``: see ``harness/readers.device_busy_ms``."""
from benchmarks.harness.readers import device_busy_ms as read  # noqa: F401
