"""The cells ``dagr_s50.stream_detect`` and ``rol.score_staged`` (its files
kept, the cell left out of ``BENCHMARK.json``) at the small test geometry: a sound run is ``correct`` and each planted fault
turns it false under the cell's own limits (an NMS at IoU 0.5, the CNN
head's sum dropped, a staged batch altered in place by its first scoring,
its boxes halved as a forward that rescaled its input would, so that its
second scoring is of other boxes).  On the card: the
detection step equals ``append`` then ``read_detections`` bit for bit, and
each cell's control fails its limits where the program passes them."""
import contextlib
import dataclasses
import json

import pytest
import torch

from benchmarks.harness import core
from benchmarks.loops import score_staged, stream_detect
from benchmarks.tests import cells

CPU = torch.device("cpu")
SEED = 2 ** 31 + 91
DETECT_MIX = dict(cells.STREAM_MIX, loop="stream_detect")


def _patched(obj, name, value):
    @contextlib.contextmanager
    def cm():
        old = getattr(obj, name)
        setattr(obj, name, value)
        try:
            yield
        finally:
            setattr(obj, name, old)
    return cm()


def detect_config():
    c = cells.config()
    spec = json.loads((cells.HERE.parent / "configs" / "dagr_s50.json")
                      .read_text())
    for k in ("yolo_stem_width", "num_scales"):
        c["fields"][k] = spec["fields"][k]
    c["detector"] = spec["detector"]
    return c


def detect_cell():
    spec = core.load_cell("dagr_s50.stream_detect")
    mix = dict(spec.mix, **DETECT_MIX)
    return dataclasses.replace(spec, config=detect_config(), mix=mix)


def staged_cell(config=None, short=True):
    """``rol.score_staged`` from its files (``BENCHMARK.json`` does not list
    it): at the small geometry under a shortened mix, or at ``config``."""
    mix = json.loads((cells.MIXES / "score_staged.json").read_text())
    if short:
        mix.update(cells.SCORE_MIX)
    e2e = [m for m in json.loads((cells.HERE.parents[1] / "BENCHMARK.json")
                                 .read_text())["end_to_end"]
           if m["name"] in ("bboxes_per_s", "setup_s")]
    return core.Cell(name="rol.score_staged",
                     config=config or cells.config(), mix=mix,
                     limits=cells.limits("rol.score_staged"), chips=1,
                     end_to_end=e2e, per_layer=[])


def _run(loop, cell, capsys, seconds=1.5):
    loop.run(cell, SEED, seconds, False, CPU, core.process_start())
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _fault(name):
    if name == "nms_at_0.5":
        from eventad_tpu_torch.models import detector
        post = detector.postprocess

        def loose(*a, **kw):
            return post(*a, **dict(kw, nms_threshold=0.5))
        return _patched(detector, "postprocess", loose)
    if name == "cnn_sum_dropped":
        from eventad_tpu_torch.streaming import detect
        update = detect.update_image_detector

        def no_cnn(*a, **kw):
            return update(*a, **kw)._replace(cnn_maps=None)
        return _patched(detect, "update_image_detector", no_cnn)
    if name == "staged_batch_altered":
        from eventad_tpu_torch.models import dagr
        fwd = dagr.model_forward

        def altering(model, batch, *a, **kw):
            out = fwd(model, batch, *a, **kw)
            batch.boxes.mul_(0.5)
            return out
        return _patched(dagr, "model_forward", altering)
    raise ValueError(name)


@pytest.mark.parametrize("fault", [None, "nms_at_0.5", "cnn_sum_dropped"])
def test_stream_detect_faults(capsys, fault):
    with _fault(fault) if fault else contextlib.nullcontext():
        out = _run(stream_detect, detect_cell(), capsys)
    assert out["correct"] == (fault is None), out["compared"]
    assert out["failed"] == 0


@pytest.mark.parametrize("fault", [None, "staged_batch_altered"])
def test_score_staged_faults(capsys, fault):
    with _fault(fault) if fault else contextlib.nullcontext():
        out = _run(score_staged, staged_cell(), capsys)
    assert out["correct"] == (fault is None), out["compared"]


def test_stream_detect_traced_reads_every_metric(capsys):
    cell = detect_cell()
    names = {m["name"] for m in cell.per_layer}
    assert {"read_detections_ms.detect", "gnn_head_ms.detect",
            "nms_ms.detect", "append_ms.stream"} <= names
    s = stream_detect.Session(cell, SEED, CPU)
    from eventad_tpu_torch.utils import spans
    spans.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(2):
            s.chunk(spans=True)
    record = {"trace": {}}
    got = {n: core.reader(n)(record) for n in names
           if n.endswith((".detect", "append_ms.stream", "gc_ms.stream"))}
    summary = spans.summary()
    spans.reset()
    assert summary["units"] == 2
    assert summary["counters"]["detect/anchors"] == 2 * 175
    assert summary["counters"]["detect/nms_steps"] == 2 * 175
    for n in ("read_detections_ms.detect", "gnn_head_ms.detect",
              "nms_ms.detect", "append_ms.stream"):
        assert got[n] > 0, (n, got)


@pytest.mark.card
def test_detection_step_bit_identical(card):
    cell = core.load_cell("dagr_s50.stream_detect")
    s = stream_detect.Session(dataclasses.replace(
        cell, mix=dict(cell.mix, warmup_chunks=2)), SEED, card)
    before = s.state
    c = s.next_chunk
    p = s.pos[c * s.k:(c + 1) * s.k].to(card)
    q = s.pol[c * s.k:(c + 1) * s.k].to(card)
    _, (dets, decoded) = s.step(before, p, q, s.k)
    dets2, decoded2 = s.step.read_detections(
        s.step.append(before, p, q, s.k))
    assert torch.equal(decoded, decoded2)
    assert all(torch.equal(dets[n], dets2[n]) for n in dets)


@pytest.mark.card
@pytest.mark.parametrize("name", ["rol.score_staged",
                                  "dagr_s50.stream_detect"])
def test_control_fails_where_the_program_passes(card, name):
    cell = (staged_cell(json.loads((cells.HERE.parent / "configs" /
                                    "rol.json").read_text()), short=False)
            if name == "rol.score_staged" else core.load_cell(name))
    loop = {"score_staged": score_staged,
            "stream_detect": stream_detect}[cell.mix["loop"]]
    out = loop.calibrate(cell, SEED, 3.0, card)
    lims = list(cell.limits.values())

    def numbers(x):
        return [x["mean"]] if isinstance(x, dict) else list(x)
    prog, ctrl = numbers(out["program"]), numbers(out["control"])
    assert all(p <= m for p, m in zip(prog, lims)), out
    assert any(c > m for c, m in zip(ctrl, lims)), out
