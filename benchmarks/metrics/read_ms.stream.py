"""``read_ms.stream``: see ``harness/program_spans.read_ms``."""
from benchmarks.harness.program_spans import read_ms as read  # noqa: F401
