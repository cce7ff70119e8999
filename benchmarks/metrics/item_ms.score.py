"""``item_ms.score``: see ``harness/program_spans.item_ms``."""
from benchmarks.harness.program_spans import item_ms as read  # noqa: F401
