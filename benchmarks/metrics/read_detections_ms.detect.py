"""``read_detections_ms.detect``: see ``harness/detect_spans.read_detections_ms``."""
from benchmarks.harness.detect_spans import read_detections_ms as read  # noqa: F401
