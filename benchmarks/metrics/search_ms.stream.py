"""``search_ms.stream``: span ``stream/search``, the neighbour search (K1)
over the ring's tail of ``lookback + chunk`` rows that an append makes,
per chunk (``harness/program_spans.span_ms``)."""
from benchmarks.harness.program_spans import span_ms


def read(record):
    return span_ms(record, "stream/search")
