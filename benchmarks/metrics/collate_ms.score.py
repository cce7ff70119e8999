"""``collate_ms.score``: see ``harness/program_spans.collate_ms``."""
from benchmarks.harness.program_spans import collate_ms as read  # noqa: F401
