"""``append_ms.stream``: see ``harness/program_spans.append_ms``."""
from benchmarks.harness.program_spans import append_ms as read  # noqa: F401
