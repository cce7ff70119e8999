"""The readers of the program's own spans (``harness/program_spans``):
None on an empty record, on an untraced one and where the program began no
unit; per-unit numbers from the program's summary; and, on the card, the
program's spans in a trace add nothing to the device operations that
``harness/trace.reduce`` counts."""
import pytest

from benchmarks.harness import core, program_spans
from eventad_tpu_torch.utils import spans

READERS = {"item_ms.score": "data/item", "collate_ms.score": "data/collate",
           "forward_host_ms.score": "model/forward",
           "gc_ms.score": "runtime/gc", "append_ms.stream": "stream/append",
           "read_ms.stream": "stream/read_scores",
           "gc_ms.stream": "runtime/gc"}

SUMMARY = {
    "units": 4,
    "spans": [
        {"name": "data/item", "parent": None, "calls": 24, "in_units": 4,
         "total_ms": 8.0, "self_ms": 8.0},
        {"name": "data/collate", "parent": None, "calls": 4, "in_units": 4,
         "total_ms": 20.0, "self_ms": 20.0},
        {"name": "model/forward", "parent": None, "calls": 4,
         "in_units": 4, "total_ms": 100.0, "self_ms": 10.0},
        {"name": "runtime/gc", "parent": "model/forward", "calls": 1,
         "in_units": 1, "total_ms": 12.0, "self_ms": 12.0},
        {"name": "runtime/gc", "parent": "data/collate", "calls": 1,
         "in_units": 1, "total_ms": 2.0, "self_ms": 2.0},
        {"name": "stream/append", "parent": "stream/step", "calls": 4,
         "in_units": 4, "total_ms": 6.0, "self_ms": 1.0},
        {"name": "stream/read_scores", "parent": "stream/step", "calls": 4,
         "in_units": 4, "total_ms": 10.0, "self_ms": 1.0},
    ],
    "counters": {"events": 10, "event_slots": 20},
}
PER_UNIT = {"item_ms.score": 2.0, "collate_ms.score": 5.0,
            "forward_host_ms.score": 25.0, "gc_ms.score": 3.5,
            "append_ms.stream": 1.5, "read_ms.stream": 2.5,
            "gc_ms.stream": 3.5}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_none_without_a_traced_segment(metric, monkeypatch):
    monkeypatch.setattr(spans, "summary", lambda: SUMMARY)
    read = core.reader(metric)
    assert read({}) is None
    assert read({"records": [], "setup_s": 1.0, "bboxes_per_s": 1.0}) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reader_per_unit(metric, monkeypatch):
    monkeypatch.setattr(spans, "summary", lambda: SUMMARY)
    assert core.reader(metric)({"trace": {}}) == pytest.approx(
        PER_UNIT[metric])


def test_reader_zero_and_none(monkeypatch):
    """A span the segment never entered reads 0; no unit at all, None."""
    monkeypatch.setattr(spans, "summary", lambda: dict(
        SUMMARY, spans=SUMMARY["spans"][:3]))
    assert program_spans.gc_ms({"trace": {}}) == 0.0
    monkeypatch.setattr(spans, "summary", lambda: dict(SUMMARY, units=0))
    assert program_spans.item_ms({"trace": {}}) is None


@pytest.mark.card
def test_program_spans_add_no_device_operation(card):
    """Under the harness's profiler session, device work inside the
    program's spans: the trace holds their device-side ranges, and the
    reduction counts exactly the device operations without them."""
    import torch
    from benchmarks.harness import trace as tr
    x = torch.randn(256, 256, device=card)
    spans.reset()
    try:
        with tr.traced() as prof:
            for _ in range(2):
                with tr.span("forward"), spans.span("model/forward"):
                    with spans.span("model/graph"):
                        y = x @ x
                    with spans.span("model/head"):
                        (y + 1).sum().item()
        events = prof.events()
        cuda = [e for e in events if str(e.device_type).endswith("CUDA")]
        ours = [e for e in cuda if e.name.startswith(spans.PREFIX)]
        work = [e for e in cuda if not getattr(e, "is_user_annotation",
                                               False)
                and not e.name.startswith(("eventad/", "bench/"))]
        assert ours and work
        red = tr.reduce(prof, 2, {})
        assert red["device_ops"] == len(work) / 2
        assert not any(n.startswith(spans.PREFIX)
                       for n, _ in red["breakdown"]["device_ops"])
        assert spans.summary()["units"] == 2
    finally:
        spans.reset()
