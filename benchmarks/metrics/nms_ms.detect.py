"""``nms_ms.detect``: see ``harness/detect_spans.nms_ms``."""
from benchmarks.harness.detect_spans import nms_ms as read  # noqa: F401
