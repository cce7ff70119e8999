"""``loader_wait_ms.score``: see ``harness/readers.loader_wait_ms``."""
from benchmarks.harness.readers import loader_wait_ms as read  # noqa: F401
