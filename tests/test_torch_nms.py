"""K9, the detection read-out's post-process as one kernel (``ops/nms``):
its algorithm, mirrored here in PyTorch (``_k9_mirror``: rank by counting,
the suppression bitmask by rank, the greedy walk over keep words, the
compaction), against the plain ``postprocess_plain`` bit for bit on
``chip_smoke.nms_cases``, the planted cases the card runs; the dispatch of
``yolox_head.postprocess``; the wrapper's refusals; ``launches/K9``.  The
kernel itself is held against the plain version on the card by
``chip_smoke.py``."""
import importlib.util
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from eventad_tpu_torch.models import detector as mdet
from eventad_tpu_torch.models import yolox_head as thead
from eventad_tpu_torch.ops import nms
from eventad_tpu_torch.utils import spans

import _torch_threads  # noqa: F401  (one intra-op thread)

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
CASES = {name: (a, kw) for name, a, kw in CS.nms_cases("cpu")}


def _k9_mirror(outputs, num_classes, *, conf_threshold, nms_threshold,
               width, height, max_out=64):
    """``csrc/nms.cu``'s algorithm, image by image, in PyTorch ops."""
    f32 = torch.float32
    m = min(outputs.shape[1], max_out)
    res = {"boxes": [], "scores": [], "labels": [], "mask": []}
    for img in outputs:
        n = img.shape[0]
        x1 = img[:, 0] - img[:, 2] * 0.5
        y1 = img[:, 1] - img[:, 3] * 0.5
        box = torch.stack([x1, y1, x1 + img[:, 2], y1 + img[:, 3]], -1)
        # the class max: the first index on ties, the first NaN
        conf, label = img[:, 5].clone(), torch.zeros(n, dtype=torch.int64)
        for k in range(1, num_classes):
            v = img[:, 5 + k]
            take = ~torch.isnan(conf) & (torch.isnan(v) | (v > conf))
            conf, label = torch.where(take, v, conf), torch.where(take, k,
                                                                  label)
        score = img[:, 4] * conf
        s = torch.where(score >= torch.tensor(conf_threshold, dtype=f32),
                        score, -torch.inf)
        sbox = box + (label.to(f32) * (max(width, height) + 1))[:, None]
        # the stable descending rank by counting
        j = torch.arange(n)
        rank = ((s[None, :] > s[:, None])
                | ((s[None, :] == s[:, None]) & (j[None, :] < j[:, None]))
                ).sum(1)
        order = torch.empty(n, dtype=torch.int64)
        order[rank] = j
        # row r, bit q: q after r and IoU(r, q) above the threshold, for
        # rows of a finite s
        alive = torch.isfinite(s[order])
        sup = (thead._iou_matrix(sbox[order]) > torch.tensor(
            nms_threshold, dtype=f32)) & (j[None, :] > j[:, None]) \
            & alive[:, None]
        words = [alive[w:w + 32].clone() for w in range(0, n, 32)]
        for r in range(n):
            if words[r // 32][r % 32]:
                for w in range(len(words)):
                    words[w] &= ~sup[r, 32 * w:32 * w + 32]
        keep = torch.cat(words)
        slots = torch.cat([torch.nonzero(keep).flatten(),
                           torch.nonzero(~keep).flatten()])[:m]
        a = order[slots]
        res["boxes"].append(box[a])
        res["scores"].append(score[a])
        res["labels"].append(label[a])
        res["mask"].append(keep[slots])
    return {k: torch.stack(v) for k, v in res.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_k9_mirror_matches_the_plain_version(name):
    (d, c), kw = CASES[name]
    want = thead.postprocess_plain(d, c, **kw)
    assert CS.same_detections(_k9_mirror(d, c, **kw), want)
    kept = want["mask"].sum(-1)
    if name == "all_below":
        assert int(kept.max()) == 0
    elif name == "few":
        assert 0 < int(kept.min()) and int(kept.max()) < 64
    else:
        assert int(kept.min()) > 0


def test_iou_ulp_case_keeps_at_and_below_and_suppresses_above():
    """The planted pairs: the second box of IoU one ulp below 0.65 and of
    0.65 kept, of one ulp above suppressed by the first."""
    (d, c), kw = CASES["iou_ulp"]
    idx, mask = thead.nms_fixed(*_boxes_scores_labels(d, c), **{
        "iou_threshold": kw["nms_threshold"],
        "score_threshold": kw["conf_threshold"], "width": kw["width"],
        "height": kw["height"]})
    for img_idx, img_mask in zip(idx, mask):
        kept = set(img_idx[img_mask].tolist())
        assert {0, 1, 2, 3, 4} <= kept and 5 not in kept


def _boxes_scores_labels(d, c):
    xy = d[..., :2] - d[..., 2:4] / 2
    conf, label = d[..., 5:5 + c].max(-1)
    return torch.cat([xy, xy + d[..., 2:4]], -1), d[..., 4] * conf, label


def test_cpu_takes_the_plain_version():
    (d, c), kw = CASES["tied"]
    before = nms.postprocess_cuda.launches
    spans.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            got = thead.postprocess(d, c, **kw)
        assert spans.summary()["counters"]["detect/nms_steps"] == 175
    finally:
        spans.reset()
    assert CS.same_detections(got, thead.postprocess_plain(d, c, **kw))
    assert nms.postprocess_cuda.launches == before


class _OnCard:
    """Stands in for a CUDA tensor at the dispatch, where the CPU tests
    have none: ``is_cuda`` and a shape."""
    is_cuda = True
    shape = (1, 175, 7)


def test_a_cuda_tensor_takes_k9_and_never_the_plain_version(monkeypatch):
    seen = []

    def k9(outputs, num_classes, **kw):
        seen.append((outputs, num_classes, kw))
        return "k9"

    def plain(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain NMS")
    monkeypatch.setattr(thead, "postprocess_cuda", k9)
    monkeypatch.setattr(thead, "postprocess_plain", plain)
    t = _OnCard()
    spans.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            assert mdet.postprocess(t, 2, conf_threshold=0.001,
                                    nms_threshold=0.65, width=360,
                                    height=240) == "k9"
        assert spans.summary()["counters"]["detect/nms_steps"] == 175
    finally:
        spans.reset()
    assert seen == [(t, 2, dict(conf_threshold=0.001, nms_threshold=0.65,
                                width=360, height=240))]


def _refused(name):
    d = torch.rand(2, 175, 7)
    kw = dict(conf_threshold=0.001, max_out=64)
    c = 2
    if name == "cpu":
        return d, c, kw, "expected a CUDA tensor"
    if name == "float64":
        return d.double(), c, kw, "float32"
    if name == "two_dims":
        return d[0], c, kw, "3-D float32"
    if name == "anchors":
        return torch.rand(1, nms.MAX_ANCHORS + 1, 7), c, kw, "anchors"
    if name == "no_anchor":
        return torch.rand(1, 0, 7), c, kw, "anchors"
    if name == "classes":
        return torch.rand(1, 8, 5 + nms.MAX_CLASSES + 1), \
            nms.MAX_CLASSES + 1, kw, "num_classes"
    if name == "no_class":
        return d, 0, kw, "num_classes"
    if name == "columns":
        return d[..., :6].contiguous(), c, kw, "columns"
    if name == "strided":
        return d.transpose(0, 1).contiguous().transpose(0, 1), c, kw, \
            "contiguous"
    if name == "threshold":
        return d, c, dict(kw, conf_threshold=0.0), "conf_threshold"
    if name == "max_out":
        return d, c, dict(kw, max_out=0), "max_out"
    if name == "gradient":
        return d.requires_grad_(), c, kw, "gradient"
    raise KeyError(name)


@pytest.mark.parametrize("name", ["cpu", "float64", "two_dims", "anchors",
                                  "no_anchor", "classes", "no_class",
                                  "columns", "strided", "threshold",
                                  "max_out", "gradient"])
def test_kernel_wrapper_refuses(name):
    d, c, kw, match = _refused(name)
    before = nms.postprocess_cuda.launches
    with pytest.raises(ValueError, match=match):
        nms.postprocess_cuda(d, c, **kw)
    assert nms.postprocess_cuda.launches == before


def test_read_out_calls_fit_the_kernel():
    """The detection read-out's decoded outputs (``decode_outputs`` of the
    head's two scales at DAGR-S's 10 x 14 and 5 x 7 grids) and keywords
    pass K9's layout check."""
    maps = [torch.rand(1, 7, 10, 14), torch.rand(1, 7, 5, 7)]
    decoded = thead.decode_outputs(maps, [8, 16])
    assert nms.postprocess_layout(decoded, 2, conf_threshold=0.001,
                                  max_out=64) == (1, 175, 64)


def test_k9_launches_are_a_span_counter():
    spans.reset()
    assert spans.KERNELS["K9"] == ("eventad_tpu_torch.ops.nms",
                                   "postprocess_cuda")
    assert "launches/K9" in spans._counter_snapshot()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            with spans.span("stream/step"):
                nms.postprocess_cuda.launches += 1
        assert spans.summary()["counters"]["launches/K9"] == 1
    finally:
        nms.postprocess_cuda.launches -= 1
        spans.reset()
