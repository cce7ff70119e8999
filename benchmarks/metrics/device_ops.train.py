"""``device_ops.train``: see ``harness/readers.device_ops``."""
from benchmarks.harness.readers import device_ops as read  # noqa: F401
