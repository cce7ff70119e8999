"""``forward_host_ms.score``: see ``harness/program_spans.forward_host_ms``."""
from benchmarks.harness.program_spans import forward_host_ms as read  # noqa: F401
