"""``kernels_roofline.stream``: see ``harness/readers.kernels_roofline``."""
from benchmarks.harness.readers import kernels_roofline as read  # noqa: F401
