"""The program's spans and counters (``eventad_tpu_torch/utils/spans``):
free with no profiler session; under one, every span of the scoring
forward, the data path (serial and prefetch-thread ``Loader``) and the
incremental stream step with its parents and calls, in the summary and in
the trace; ``collate``'s counters and the stream's (host integers); a
garbage collection as ``runtime/gc``; ``reset()`` taking the collection
callback out."""
import gc
import itertools
import tracemalloc
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from eventad_tpu_torch.config import Config
from eventad_tpu_torch.data.batching import Loader
from eventad_tpu_torch.data.dataset import MemoryDataset
from eventad_tpu_torch.data.fixtures import make_sequence
from eventad_tpu_torch.data.synthetic import make_synthetic_batch
from eventad_tpu_torch.models.dagr import (graph_static_config, init_model,
                                           model_forward)
from eventad_tpu_torch.streaming import incremental as inc
from eventad_tpu_torch.utils import spans

import _torch_threads  # noqa: F401  (one intra-op thread)

KW = dict(batch_size=2, width=48, height=36, scale=1, use_image=True,
          img_net="resnet18", event_buckets=(512,), graph_lookback=256)

FORWARD = {
    "model/forward": None, "model/graph": "model/forward",
    "model/cnn": "model/forward", "model/backbone": "model/forward",
    **{f"model/level{i}": "model/backbone" for i in range(5)},
    "model/box_features": "model/forward", "model/head": "model/forward",
}
STREAM = {
    "stream/update_image": None,
    "stream/refresh": None, "stream/step": None,
    "stream/append": "stream/step", "stream/search": "stream/append",
    "stream/layer0": "stream/append",
    "stream/read_scores": "stream/step", "stream/levels":
    "stream/read_scores", "stream/head": "stream/read_scores",
    **{f"model/level{i}": "stream/levels" for i in range(1, 5)},
}


@pytest.fixture(autouse=True)
def clean():
    spans.reset()
    yield
    spans.reset()


def _cpu_profile(**kw):
    return profile(activities=[ProfilerActivity.CPU], **kw)


def _rows(summary, gc_too=False):
    """The summary's span rows by (name, parent); without ``gc_too``
    those of the collections that happened to run."""
    return {(r["name"], r["parent"]): r for r in summary["spans"]
            if gc_too or r["name"] != spans.GC}


def _check_trace(prof, rows):
    """Every recorded span is in the trace, each interval inside one of
    its parent's."""
    ev = {}
    for e in prof.events():
        if e.name.startswith(spans.PREFIX) and \
                not str(e.device_type).endswith("CUDA"):
            ev.setdefault(e.name[len(spans.PREFIX):], []).append(
                (e.time_range.start, e.time_range.end))
    calls, parents = {}, {}
    for (name, parent), r in rows.items():
        calls[name] = calls.get(name, 0) + r["calls"]
        parents.setdefault(name, set()).add(parent)
    for name, n in calls.items():
        assert len(ev.get(name, ())) == n, name
        if None in parents[name]:
            continue
        outer = [iv for p in parents[name] for iv in ev[p]]
        for s, e in ev[name]:
            assert any(ps <= s and e <= pe for ps, pe in outer), name


def test_no_session_records_nothing_and_costs_one_check(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("read or opened with no session")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(spans, "perf_counter_ns", refuse)
    names = ["model/forward", "data/item", "stream/step"]
    assert all(spans.span(n) is spans.NULL for n in names)
    with spans.span("model/forward"):
        with spans.span("model/graph"):
            spans.count("events", 3)
    gc.collect()
    tracemalloc.start()
    try:
        spans.span("model/forward")
        loop = itertools.repeat(None, 1000)
        tracemalloc.reset_peak()
        before = tracemalloc.get_traced_memory()[0]
        for _ in loop:
            spans.span("model/forward")
            spans.count("events", 1)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak == before       # nothing allocated, not even for a while
    assert spans.summary() == {"units": 0, "spans": [], "counters": {}}
    assert spans._on_gc not in gc.callbacks


def test_forward_spans():
    cfg = Config(**KW)
    model, bc, mc = init_model(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    batch = make_synthetic_batch(cfg, seed=1)
    with _cpu_profile() as prof, torch.no_grad():
        model_forward(model, batch, bc, mc, graph_static_config(cfg))
    s = spans.summary()
    rows = _rows(s)
    for name, parent in FORWARD.items():
        r = rows[(name, parent)]
        assert r["calls"] == 1 and r["in_units"] == 1, name
        assert 0 <= r["self_ms"] <= r["total_ms"]
    for i in range(1, 5):
        assert rows[("model/pool", f"model/level{i}")]["calls"] == 1
    assert len(rows) == len(FORWARD) + 4
    assert s["units"] == 1
    fwd = rows[("model/forward", None)]
    kids = sum(r["total_ms"] for (n, p), r in rows.items()
               if p == "model/forward")
    assert fwd["total_ms"] >= kids
    assert fwd["self_ms"] == pytest.approx(fwd["total_ms"] - kids,
                                           abs=1e-6)
    _check_trace(prof, rows)


def _dataset(cfg):
    seqs = [make_sequence(f"s{i}", cfg, n_frames=2, n_objects=2, seed=i,
                          events_per_window=300, frame_scale=1)
            for i in range(cfg.batch_size)]
    return MemoryDataset(cfg, seqs)


@pytest.mark.parametrize("mode", ["serial", "thread"])
def test_loader_spans_and_counters(mode):
    cfg = Config(**KW)
    ds = _dataset(cfg)
    assert len(ds) == cfg.batch_size    # one batch: the producer stops
    loader = Loader(ds, cfg, prefetch=0 if mode == "serial" else 1,
                    num_workers=0)
    assert loader.mode() == mode
    kw = {}
    if mode == "thread":
        from torch._C._profiler import _ExperimentalConfig
        kw["experimental_config"] = _ExperimentalConfig(
            profile_all_threads=True)
    with _cpu_profile(**kw) as prof:
        (batch, _meta), = list(loader)
    s = spans.summary()
    rows = _rows(s)
    assert set(rows) == {("data/item", None), ("data/collate", None)}
    assert rows[("data/item", None)]["calls"] == cfg.batch_size
    assert rows[("data/collate", None)]["calls"] == 1
    assert s["units"] == 0
    assert s["counters"]["events"] == int(batch.valid.sum())
    assert s["counters"]["event_slots"] == cfg.batch_size * 512
    assert s["counters"]["events"] < s["counters"]["event_slots"]
    _check_trace(prof, rows)


def _stream():
    """A small stream: its model, ``refresh`` and ``step``, an empty state,
    its first ``n_buf + k`` events and a frame's boxes."""
    cfg = Config(**dict(KW, batch_size=1))
    model, bc, mc = init_model(cfg, torch.Generator().manual_seed(0),
                               device="cpu")
    n_buf, k = 512, 128
    refresh, step = inc.make_incremental_step(
        model, bc, mc, graph_static_config(cfg), n_chunk=k, n_buf=n_buf)
    rng = np.random.default_rng(0)
    t = np.sort(rng.integers(0, 900_000, n_buf + k))
    pos = torch.from_numpy(np.stack([rng.integers(0, 48, n_buf + k),
                                     rng.integers(0, 36, n_buf + k), t],
                                    1).astype(np.int32))
    pol = torch.ones(n_buf + k)
    boxes = torch.tensor([[0, 0, 0, 0]] + [[4.0, 4, 20, 16]] * 3
                         + [[0, 0, 0, 0]] * (mc.max_boxes - 3))
    present = torch.zeros(mc.max_boxes + 1, dtype=torch.bool)
    present[1:4] = True
    st = inc.init_incremental_state(n_buf, bc, mc, cfg.max_neighbors,
                                    device="cpu")
    return SimpleNamespace(model=model, refresh=refresh, step=step, st=st,
                           pos=pos, pol=pol, boxes=boxes, present=present,
                           n_buf=n_buf, k=k)


def _filled(s):
    """``s``'s state after the frame's image and a refresh of the first
    ``n_buf`` events."""
    st = inc.update_image(s.model, s.st, torch.rand(36, 48, 3))
    return s.refresh(inc.insert_raw(st, s.pos[:s.n_buf], s.pol[:s.n_buf],
                                    s.n_buf))


def test_incremental_step_spans():
    s = _stream()
    with _cpu_profile() as prof:
        st = _filled(s)
        st, logits = s.step(st, s.pos[s.n_buf:], s.pol[s.n_buf:], s.k,
                            s.boxes, s.present)
    assert torch.isfinite(logits).all()
    summary = spans.summary()
    rows = _rows(summary)
    for name, parent in STREAM.items():
        assert rows[(name, parent)]["calls"] == 1, (name, parent)
    assert summary["units"] == 1
    assert rows[("stream/step", None)]["in_units"] == 1
    _check_trace(prof, rows)


def test_stream_counters_are_host_integers(monkeypatch):
    """One traced ``append`` and ``read_scores``: ``stream/search_rows``
    counts the tail the search ran over (``lookback + k``, the lookback
    256 of ``KW``) and ``stream/ring_rows`` the ring a read pools, each
    given as a Python int taken from shapes, so that recording them reads
    no device value (on the card, a tensor turned into a number is a copy
    to the host that waits for the card)."""
    s = _stream()
    st = _filled(s)
    given = []

    def count(name, n):
        given.append((name, type(n)))
        spans.count(name, n)
    monkeypatch.setattr(inc, "count", count)
    with _cpu_profile():
        st = s.step.append(st, s.pos[s.n_buf:], s.pol[s.n_buf:], s.k)
        s.step.read_scores(st, s.boxes, s.present)
    assert given == [("stream/search_rows", int),
                     ("stream/ring_rows", int)]
    counters = spans.summary()["counters"]
    assert counters["stream/search_rows"] == 256 + s.k
    assert counters["stream/ring_rows"] == s.n_buf


def test_gc_inside_a_span_and_reset():
    with _cpu_profile() as prof:
        with spans.span("model/forward"):
            gc.collect()
    assert spans._on_gc in gc.callbacks
    s = spans.summary()
    rows = _rows(s, gc_too=True)
    assert rows[("runtime/gc", "model/forward")]["calls"] >= 1
    assert s["counters"]["gc/gen2"] >= 1
    _check_trace(prof, rows)
    spans.reset()
    assert spans._on_gc not in gc.callbacks
    gc.collect()
    assert spans.summary()["spans"] == []


def _ev(name, start, end, device=False, id=0, annotation=False):
    return SimpleNamespace(
        name=name, id=id, thread=1, is_user_annotation=annotation,
        device_type="DeviceType.CUDA" if device else "DeviceType.CPU",
        time_range=SimpleNamespace(start=start, end=end))


def test_profile_step_stages_and_gaps_on_a_synthetic_trace():
    """One traced call: device work joined to the span open at its launch,
    host-blocking calls, an unjoined operation, the union busy time over
    the traced window, and the idle gaps named by the innermost span."""
    from eventad_tpu_torch.tools import profile_step as ps
    p = spans.PREFIX
    events = [
        _ev(ps.CALL, 0, 1000),
        _ev(p + "model/forward", 10, 900, annotation=True),
        _ev(p + "model/graph", 20, 100, annotation=True),
        _ev(p + "runtime/gc", 300, 500, annotation=True),
        _ev(p + "model/head", 600, 800, annotation=True),
        _ev(p + "model/forward", 40, 835, device=True, annotation=True),
        _ev("cudaLaunchKernel", 30, 35, id=101),
        _ev("search_kernel", 40, 90, device=True, id=101),
        _ev("cudaLaunchKernel", 610, 615, id=102),
        _ev("gru_kernel", 620, 700, device=True, id=102),
        _ev("cudaMemcpyAsync", 820, 830, id=103),
        _ev("Memcpy DtoH (Device -> Pageable)", 830, 835, device=True,
            id=103),
        _ev("cudaStreamSynchronize", 840, 860, id=104),
        _ev("unlaunched_kernel", 950, 960, device=True, id=105),
    ]
    summary = {"units": 1, "counters": {"events": 7}, "spans": [
        {"name": "model/forward", "parent": None, "calls": 1,
         "in_units": 1, "total_ms": 0.89, "self_ms": 0.41},
        {"name": "model/graph", "parent": "model/forward", "calls": 1,
         "in_units": 1, "total_ms": 0.08, "self_ms": 0.08},
        {"name": "runtime/gc", "parent": "model/forward", "calls": 1,
         "in_units": 1, "total_ms": 0.2, "self_ms": 0.2},
        {"name": "model/head", "parent": "model/forward", "calls": 1,
         "in_units": 1, "total_ms": 0.2, "self_ms": 0.2}]}
    out = ps.device_summary(events, 1, summary)
    assert out["device_ops_per_step"] == 4
    assert out["device_busy_ms_per_step"] == pytest.approx(0.145)
    assert out["device_idle_share"] == pytest.approx(1 - 145 / 1000)
    assert out["unjoined_device_ops"] == 1
    assert [(g["span"], g["ms"]) for g in out["idle_gaps"]] == [
        ("runtime/gc", 0.53), ("model/head", 0.13), ("model/forward", 0.115)]
    rows = {(r["name"], r["parent"]): r for r in out["stages"]}
    assert rows[("model/graph", "model/forward")]["device_ops"] == 1
    assert rows[("model/graph", "model/forward")]["device_busy_ms"] == \
        pytest.approx(0.05)
    assert rows[("model/head", "model/forward")]["device_busy_ms"] == \
        pytest.approx(0.08)
    fwd = rows[("model/forward", None)]
    assert fwd["host_self_ms"] == pytest.approx(0.41)
    assert fwd["blocking_calls"] == 2
    assert fwd["blocking_ms"] == pytest.approx(0.03)
    assert rows[("runtime/gc", "model/forward")]["device_ops"] == 0
    assert out["counters_per_step"] == {"events": 7}
