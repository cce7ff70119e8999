"""``gnn_head_ms.detect``: see ``harness/detect_spans.gnn_head_ms``."""
from benchmarks.harness.detect_spans import gnn_head_ms as read  # noqa: F401
