"""``kernels_roofline.train``: see ``harness/readers.kernels_roofline``."""
from benchmarks.harness.readers import kernels_roofline as read  # noqa: F401
