"""``mfu.train``: see ``harness/readers.mfu``."""
from benchmarks.harness.readers import mfu as read  # noqa: F401
