"""``levels_ms.stream``: span ``stream/levels``, the pooling of the whole
ring into level 1 (K8) and levels 1-4 (K3) that a read runs, per chunk
(``harness/program_spans.span_ms``)."""
from benchmarks.harness.program_spans import span_ms


def read(record):
    return span_ms(record, "stream/levels")
