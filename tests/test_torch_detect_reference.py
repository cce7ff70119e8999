"""The port's DAGR detector against the benchmark's plain reference
(``benchmarks/reference/detect.py``), on the CPU at the fixture geometry
(96x72, 1 024 - 4 096 events) with seeded random weights
(``benchmarks/reference/detect_weights``): the batch ``detector_forward``'s
maps and decoded outputs in f32, the streaming detector's step after a
refresh and three appends against the reference's read of the same ring,
the reference NMS against ``nms_fixed`` on crafted ties and IoUs at the
threshold, and the detection spans and counters under a profiler
session.  Nothing of JAX is used here."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmarks.harness.traffic import sequences
from benchmarks.reference import data as rdata
from benchmarks.reference import detect as rdet
from benchmarks.reference import model as rmodel
from benchmarks.reference import stream as rstream
from benchmarks.reference.detect_weights import (detector_tree,
                                                 fit_cnn_statistics,
                                                 make_head)
from benchmarks.reference.geometry import Geometry
from benchmarks.reference.weights import make_state
from eventad_tpu_torch.config import Config
from eventad_tpu_torch.models import yolox_head as thead
from eventad_tpu_torch.models.backbone import make_backbone_config
from eventad_tpu_torch.models.convert import load_detector_state
from eventad_tpu_torch.models.dagr import graph_static_config
from eventad_tpu_torch.models.detector import (decode_detections,
                                               detector_maps, init_detector)
from eventad_tpu_torch.models.eventad import EventADConfig
from eventad_tpu_torch.streaming import detect as sdet
from eventad_tpu_torch.streaming import incremental as inc
from eventad_tpu_torch.utils import spans

import _torch_threads  # noqa: F401  (one intra-op thread)

FIELDS = dict(width=96, height=72, scale=1, batch_size=2,
              event_buckets=(1024, 2048, 4096), graph_lookback=256)
TRAFFIC = dict(frame_us=50000, events_per_window=2600,
               item_events=[1400, 2048], over_share=0.1,
               over_events=[2049, 2400])
N_BUF, N_CHUNK = 1024, 256
TOL = 1e-4          # of each column's (map's) scale, f32 both sides
HEAD = rdet.Head()
SEED = 2 ** 31 + 5


def _column_err(got, want):
    """Largest gap over each last-axis column's scale (at least 1)."""
    scale = want.abs().amax(dim=tuple(range(want.dim() - 1))).clamp(min=1.0)
    return float(((got - want).abs().amax(
        dim=tuple(range(want.dim() - 1))) / scale).max())


@pytest.fixture(scope="module")
def world():
    """Weights, a batch of two items and one long sequence's events."""
    geo = Geometry.of(FIELDS)
    cfg = Config(**FIELDS)
    mix = dict(frames=6, objects=4, anomalous_every=3, toa_frame=3)
    seqs, _ = sequences(geo, TRAFFIC, mix, 3, 1)
    batch = rmodel.to_device(rdata.collate(
        [rdata.cut(seqs[0], i, geo) for i in range(2)], geo), "cpu")
    sd = make_state(geo, SEED, "cpu")
    hd = fit_cnn_statistics(sd, make_head(geo, HEAD, SEED, "cpu"),
                            batch["image"], geo)
    detector, bc = init_detector(cfg, None, "cpu")
    load_detector_state(detector, *detector_tree(sd, hd, geo))
    ev = seqs[0]["events"]
    pos = torch.from_numpy(np.stack([ev["x"], ev["y"], ev["t"]], 1)
                           .astype(np.int32))
    pol = torch.from_numpy((2.0 * ev["p"] - 1.0).astype(np.float32))
    return SimpleNamespace(geo=geo, cfg=cfg, sd=sd, hd=hd, batch=batch,
                           detector=detector, bc=bc, pos=pos, pol=pol)


def test_detector_forward_matches_reference(world):
    b = world.batch
    batch = SimpleNamespace(pos=b["pos"], polarity=b["polarity"],
                            valid=b["valid"], rank=b["rank"],
                            image=b["image"])
    with torch.no_grad():
        maps, strides = detector_maps(world.detector, batch, world.cfg,
                                      world.bc)
        dets, decoded = decode_detections(maps, strides, world.bc)
    rmaps, rdecoded = rdet.forward(world.sd, world.hd, b, world.geo)
    for s in range(2):
        for got, want in zip(maps[s], rmaps[s]):
            assert got.shape == want.shape
            err = float((got - want).abs().max()
                        / want.abs().max().clamp(min=1.0))
            assert err <= TOL, (s, err)
    assert decoded.shape == (2, 175, 7)
    assert _column_err(decoded, rdecoded) <= TOL
    w, h = world.geo.model_width, world.geo.model_height
    kept = rdet.nms(rdecoded, HEAD, w, h)
    assert all(len(k) > 0 for k in kept)
    assert rdet.kept_of(dets, decoded, HEAD) == kept


def test_stream_step_matches_reference_read(world):
    """A refresh of the raw ring and three steps, against the reference's
    ring built by appends from empty over the same events (the same ring:
    nothing precedes the stream's first event); the step also equals
    ``append`` then ``read_detections`` bit for bit."""
    geo1 = dataclasses.replace(world.geo, batch_size=1)
    cfg1 = world.cfg.replace(batch_size=1)
    bc1 = make_backbone_config(cfg1)
    refresh, step = sdet.make_incremental_detector(
        world.detector, bc1, graph_static_config(cfg1), n_chunk=N_CHUNK,
        n_buf=N_BUF)
    image = world.batch["image"][0]
    st = inc.init_incremental_state(N_BUF, bc1, EventADConfig(),
                                    cfg1.max_neighbors, device="cpu")
    st = sdet.update_image_detector(world.detector, st, image, bc1)
    st = refresh(inc.insert_raw(st, world.pos[:N_BUF], world.pol[:N_BUF],
                                N_BUF))
    n_chunks = N_BUF // N_CHUNK + 3
    for c in range(N_BUF // N_CHUNK, n_chunks):
        chunk = slice(c * N_CHUNK, (c + 1) * N_CHUNK)
        before = st
        st, (dets, decoded) = step(st, world.pos[chunk], world.pol[chunk],
                                   N_CHUNK)
    dets2, decoded2 = step.read_detections(step.append(
        before, world.pos[chunk], world.pol[chunk], N_CHUNK))
    assert torch.equal(decoded, decoded2)
    assert all(torch.equal(dets[k], dets2[k]) for k in dets)

    feats = rmodel.cnn_features(world.sd, image[None], geo1)
    cnn = rdet.cnn_head(world.sd, world.hd, image[None], geo1)
    ring = rstream.empty_ring(N_BUF, geo1, "cpu")
    for c in range(n_chunks):
        chunk = slice(c * N_CHUNK, (c + 1) * N_CHUNK)
        ring = rstream.append(world.sd, geo1, feats, ring, world.pos[chunk],
                              world.pol[chunk])
    rdecoded = rdet.read(world.sd, world.hd, geo1, feats, cnn, ring)
    assert decoded.shape == (1, 175, 7)
    assert _column_err(decoded, rdecoded) <= TOL
    kept = rdet.nms(rdecoded, HEAD, geo1.model_width, geo1.model_height)
    assert rdet.kept_of(dets, decoded, HEAD) == kept


def _crafted(case: int):
    """``decoded [2, 175, 7]``: random anchors (odd cases: scores tied in
    steps of 1/8; cases 2 and 3: scores around the 0.001 floor, so that
    fewer than 64 are kept), then, scored first, box pairs whose IoU is
    0.65 exactly, just above and just below (``w / 10`` for a box of width
    ``w`` inside a 10 x 10 one) and a pair of two classes; anchor 8 at the
    score floor, anchor 9 below it."""
    g = torch.Generator().manual_seed(case)
    d = torch.rand(2, 175, 7, generator=g)
    d[..., :2] *= 90
    d[..., 2:4] = d[..., 2:4] * 30 + 2
    if case % 2:
        d[..., 4:] = torch.round(d[..., 4:] * 8) / 8
    if case >= 2:
        d[..., 4] *= 0.002
    step = 2.0 ** -20
    for j, w in enumerate((6.5, 6.5 + step * 8, 6.5 - step * 8, 6.5)):
        a, b = 2 * j, 2 * j + 1
        x0 = 12.0 * j
        d[:, a, :4] = torch.tensor([x0 + 5, 205, 10, 10])
        d[:, b, :4] = torch.tensor([x0 + w / 2, 205, w, 10])
        d[:, a, 4:] = torch.tensor([1.0, 0.99, 0.01])
        # the last pair: the second box of the other class
        d[:, b, 4:] = torch.tensor([1.0, 0.01, 0.98] if j == 3
                                   else [1.0, 0.98, 0.01])
    d[:, 8, 4:] = torch.tensor([1.0, 0.001, 0.0005])
    d[:, 9, 4:] = torch.tensor([1.0, 0.0005, 0.0009])
    return d


@pytest.mark.parametrize("case", range(4))
def test_reference_nms_matches_nms_fixed(case):
    d = _crafted(case)
    dets = thead.postprocess(d, 2, width=96, height=72)
    kept = rdet.nms(d, HEAD, 96, 72)
    assert rdet.kept_of(dets, d, HEAD) == kept
    assert [int(m.sum()) for m in dets["mask"]] == [len(k) for k in kept]
    for k in kept:
        # IoU at 0.65 kept, just above dropped, just below kept; the
        # other class kept
        assert 1 in k and 3 not in k and 5 in k and 7 in k
        if case >= 2:
            assert len(k) < 64 and 8 in k and 9 not in k


def test_detection_spans_and_counters(world):
    cfg1 = world.cfg.replace(batch_size=1)
    bc1 = make_backbone_config(cfg1)
    refresh, step = sdet.make_incremental_detector(
        world.detector, bc1, graph_static_config(cfg1), n_chunk=N_CHUNK,
        n_buf=N_BUF)
    st = inc.init_incremental_state(N_BUF, bc1, EventADConfig(),
                                    cfg1.max_neighbors, device="cpu")
    image = world.batch["image"][0]
    st = sdet.update_image_detector(world.detector, st, image, bc1)
    st = refresh(inc.insert_raw(st, world.pos[:N_BUF], world.pol[:N_BUF],
                                N_BUF))
    spans.reset()
    steps = 2
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        sdet.update_image_detector(world.detector, st, image, bc1)
        for c in range(steps):
            chunk = slice(N_BUF + c * N_CHUNK, N_BUF + (c + 1) * N_CHUNK)
            st, _ = step(st, world.pos[chunk], world.pol[chunk], N_CHUNK)
    s = spans.summary()
    spans.reset()
    assert s["units"] == steps
    rows = {(r["name"], r["parent"]): r for r in s["spans"]}
    for name, parent in (("stream/step", None),
                         ("stream/append", "stream/step"),
                         ("stream/read_detections", "stream/step"),
                         ("stream/levels", "stream/read_detections"),
                         ("detect/gnn_head", "stream/read_detections"),
                         ("detect/decode", "stream/read_detections"),
                         ("detect/nms", "stream/read_detections")):
        assert rows[(name, parent)]["calls"] == steps, name
    assert rows[("stream/update_image_detector", None)]["calls"] == 1
    assert s["counters"]["detect/anchors"] == 175 * steps
    assert s["counters"]["detect/nms_steps"] == 175 * steps
