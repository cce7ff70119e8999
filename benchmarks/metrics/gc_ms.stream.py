"""``gc_ms.stream``: see ``harness/program_spans.gc_ms``."""
from benchmarks.harness.program_spans import gc_ms as read  # noqa: F401
