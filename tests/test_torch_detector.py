"""Detection serving: the port's decode, NMS, post-processing and
``DetectionBuffer`` against the JAX package's on seeded inputs, and the
slice as a whole — ``detector_forward`` with the JAX package's weights
carried over by ``load_detector_state`` — in f32 (batch-statistics and
eval mode) and in bf16, at the fixture geometry of ``tests/test_detector.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventad_tpu.config import Config as JaxConfig
from eventad_tpu.data.synthetic import make_synthetic_batch as jax_batch
from eventad_tpu.models import backbone as jbb
from eventad_tpu.models import detector as jdet
from eventad_tpu.models import yolox_head as jhead
from eventad_tpu.ops.norm import BatchNormParams, BatchNormState, \
    batch_norm as jax_batch_norm
from eventad_tpu.ops.spline_conv import cartesian_attr as jax_cartesian
from eventad_tpu.utils import detection_eval as jeval
from eventad_tpu_torch import bench_detector, test_detector as det_eval
from eventad_tpu_torch.config import Config
from eventad_tpu_torch.data.synthetic import (make_synthetic_batch,
                                              synthetic_loader)
from eventad_tpu_torch.models import yolox_head as thead
from eventad_tpu_torch.models.convert import load_detector_state
from eventad_tpu_torch.models.detector import (detector_forward,
                                               detector_maps, init_detector)
from eventad_tpu_torch.ops.norm import BatchNorm, batch_norm
from eventad_tpu_torch.ops.spline_conv import cartesian_attr
from eventad_tpu_torch.utils import detection_eval as teval

import _torch_threads  # noqa: F401  (one intra-op thread)

KW = dict(batch_size=2, width=96, height=72, scale=1, use_image=True,
          event_buckets=(1024,), graph_lookback=256)
F32_TOL = 1e-4      # relative to the scale, f32 both sides


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    return np.abs(got - want).max() / max(1.0, np.abs(want).max())


# ---------------------------------------------------------------------------
# decode, NMS, post-processing, evaluation
# ---------------------------------------------------------------------------
def test_decode_outputs_matches():
    rng = np.random.RandomState(0)
    maps = [rng.randn(2, 7, 10, 14).astype(np.float32),
            rng.randn(2, 7, 5, 7).astype(np.float32)]
    want = jhead.decode_outputs([jnp.asarray(m) for m in maps], [7, 14])
    got = thead.decode_outputs([torch.from_numpy(m) for m in maps], [7, 14])
    assert got.shape == (2, 175, 7) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    half = thead.decode_outputs([torch.from_numpy(m).bfloat16()
                                 for m in maps], [7, 14])
    assert half.dtype == torch.float32


def _boxes(rng, n, tied):
    xy = rng.rand(n, 2) * 60
    wh = rng.rand(n, 2) * 30 + 4
    boxes = np.concatenate([xy, xy + wh], 1).astype(np.float32)
    scores = rng.rand(n).astype(np.float32)
    if tied:                 # many equal scores, some below the threshold
        scores = np.round(scores * 4) / 4
    return boxes, scores, rng.randint(0, 2, n).astype(np.int32)


@pytest.mark.parametrize("tied", [False, True])
def test_nms_fixed_matches_exactly(tied):
    rng = np.random.RandomState(1)
    boxes, scores, cls = _boxes(rng, 175, tied)
    kw = dict(iou_threshold=0.1, score_threshold=0.2, max_out=64, width=96,
              height=72)
    idx, mask = jhead.nms_fixed(jnp.asarray(boxes), jnp.asarray(scores),
                                jnp.asarray(cls), **kw)
    tidx, tmask = thead.nms_fixed(torch.from_numpy(boxes),
                                  torch.from_numpy(scores),
                                  torch.from_numpy(cls), **kw)
    assert tidx.shape == (64,) and tmask.dtype == torch.bool
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(mask))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(idx))
    assert 4 < int(tmask.sum()) < 64


def test_postprocess_matches_exactly():
    rng = np.random.RandomState(2)
    out = rng.rand(3, 175, 7).astype(np.float32)
    out[..., :2] *= 80
    out[..., 2:4] = out[..., 2:4] * 30 + 4
    out[..., 4:] = np.round(out[..., 4:] * 8) / 8         # ties
    kw = dict(conf_threshold=0.3, nms_threshold=0.1, width=96, height=72)
    want = jhead.postprocess(jnp.asarray(out), 2, **kw)
    got = thead.postprocess(torch.from_numpy(out), 2, **kw)
    assert set(got) == {"boxes", "scores", "labels", "mask"}
    assert got["boxes"].shape == (3, 64, 4)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    assert 0 < int(got["mask"].sum()) < 3 * 64


def test_detection_buffer_matches():
    rng = np.random.RandomState(3)
    bufs = [jeval.DetectionBuffer(2), teval.DetectionBuffer(2)]
    for _ in range(6):
        gb, _, gl = _boxes(rng, 5, False)
        db, ds, dl = _boxes(rng, 12, True)
        db[:4] = gb[:4] + rng.randn(4, 4).astype(np.float32) * 2
        dl[:4] = gl[:4]
        det = {"boxes": db, "scores": ds, "labels": dl,
               "mask": rng.rand(12) > 0.2}
        for buf in bufs:
            buf.update([det], [{"boxes": gb, "labels": gl}])
    want, got = (b.compute() for b in bufs)
    assert got == want and 0 < got["mAP"] < got["mAP_50"] <= 1
    np.testing.assert_array_equal(teval.box_iou(db, gb), jeval.box_iou(db, gb))
    t = np.sort(rng.randint(0, 10**6, 40))
    seq = {"t": t, "boxes": np.tile(gb, (8, 1)), "labels": np.tile(gl, 8)}
    dts = dict(seq, scores=np.tile(ds[:5], 8))
    assert teval.evaluate_detection_windowed([seq], [dts]) == \
        jeval.evaluate_detection_windowed([seq], [dts])
    with pytest.raises(ValueError, match="sorted"):
        teval.evaluate_detection_windowed([dict(seq, t=t[::-1])], [dts])


def test_batch_statistics_norm_and_cartesian_attr_match():
    rng = np.random.RandomState(4)
    x = (rng.randn(300, 8) * 3 + 1).astype(np.float32)
    mask = rng.rand(300) > 0.3
    arr = [rng.rand(8).astype(np.float32) + 0.5 for _ in range(4)]
    bn = BatchNorm(8)
    with torch.no_grad():
        for dst, a in zip((bn.scale, bn.offset, bn.mean, bn.var), arr):
            dst.copy_(torch.from_numpy(a))
    want, ns = jax_batch_norm(
        jnp.asarray(x), jnp.asarray(mask),
        BatchNormParams(jnp.asarray(arr[0]), jnp.asarray(arr[1])),
        BatchNormState(jnp.asarray(arr[2]), jnp.asarray(arr[3])),
        training=True)
    got = batch_norm(torch.from_numpy(x), torch.from_numpy(mask), bn,
                     training=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(ns.mean),
                               rtol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(ns.var), rtol=1e-6)
    nbr = rng.randint(0, 300, (300, 9)).astype(np.int32)
    nmask = rng.rand(300, 9) > 0.4
    pos = rng.rand(300, 3).astype(np.float32)
    np.testing.assert_allclose(
        cartesian_attr(torch.from_numpy(pos), torch.from_numpy(nbr),
                       torch.from_numpy(nmask), 0.2).numpy(),
        np.asarray(jax_cartesian(jnp.asarray(pos), jnp.asarray(nbr),
                                 jnp.asarray(nmask), 0.2)), atol=1e-6)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------
def _seeded_detector(jcfg):
    """``DetectorParams`` / ``DetectorState`` of the reference package's
    shapes (traced, not run) filled from a numpy seed: weights at the scale
    of its own initialisers, BN scales near 1, running variances positive."""
    shapes = jax.eval_shape(lambda k: jdet.init_detector(k, jcfg)[:2],
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(0)

    def fill(path, leaf):
        name = next(str(getattr(k, "name", getattr(k, "key", "")))
                    for k in reversed(path)
                    if not hasattr(k, "idx"))
        if name == "var":
            a = 0.5 + rng.rand(*leaf.shape)
        elif name == "scale":
            a = 0.8 + 0.4 * rng.rand(*leaf.shape)
        elif name in ("mean", "offset", "bias", "b", "skip_lin_bias"):
            a = 0.1 * rng.randn(*leaf.shape)
        elif leaf.ndim == 4:         # image convs, He-normal
            a = rng.randn(*leaf.shape) * np.sqrt(2 / np.prod(leaf.shape[:-1]))
        else:                        # spline kernels, roots, linear maps
            a = (rng.rand(*leaf.shape) * 2 - 1) \
                / np.sqrt(np.prod(leaf.shape[:-1]))
        return jnp.asarray(a.astype(np.float32))
    return jax.tree_util.tree_map_with_path(fill, shapes)


@pytest.fixture(scope="module")
def pair():
    """Both detectors with the same weights and the same batch; the JAX
    forward in batch-statistics mode, compiled once.  Random weights on the
    initial running statistics overflow the ``exp`` of the box decode in
    eval mode (tests/test_detector.py:20-22), so the eval comparison runs
    on running statistics set to that pass's batch statistics, worked out
    on the arrays from the state the pass returns."""
    jcfg = JaxConfig(**KW)
    jbc = jbb.make_backbone_config(jcfg)
    params, state = _seeded_detector(jcfg)
    jb = jax.tree.map(jnp.asarray, jax_batch(jcfg, events_per_item=1024)
                      ._replace(pool_tables=None, search_starts=None,
                                image_s2d=None))
    fwd = {t: jax.jit(lambda p, s, b, t=t: jdet.detector_forward(
        p, s, b, jcfg, jbc, training=t)) for t in (True, False)}
    dets, decoded, new_state = fwd[True](params, state, jb)
    momentum = 0.1
    calibrated = jax.tree.map(
        lambda new, old: (np.asarray(new) - (1 - momentum) * np.asarray(old))
        / momentum, new_state, state)
    cfg = Config(**KW)
    detector, bc = init_detector(cfg, torch.Generator().manual_seed(1), "cpu")
    load_detector_state(detector, _np_tree(params), _np_tree(state))
    return dict(cfg=cfg, bc=bc, detector=detector, params=params,
                state=state, calibrated=calibrated, jb=jb, jbc=jbc,
                jcfg=jcfg, fwd=fwd,
                batch=make_synthetic_batch(cfg, events_per_item=1024),
                train=(dets, decoded, new_state))


def _check_detections(got, want, decoded, want_decoded):
    assert decoded.shape == (2, 175, 7) and decoded.dtype == torch.float32
    assert torch.isfinite(decoded).all()
    want_decoded = np.asarray(want_decoded)
    for cols in (slice(0, 2), slice(2, 4), slice(4, 7)):   # xy, wh, obj/cls
        err = _rel(decoded[..., cols], want_decoded[..., cols])
        assert err < F32_TOL, (cols, err)
    np.testing.assert_array_equal(got["mask"].numpy(),
                                  np.asarray(want["mask"]))
    m = got["mask"].numpy()
    assert m.sum() > 0
    np.testing.assert_array_equal(got["labels"].numpy()[m],
                                  np.asarray(want["labels"])[m])
    np.testing.assert_allclose(got["boxes"].numpy()[m],
                               np.asarray(want["boxes"])[m], rtol=1e-3,
                               atol=1e-2)
    np.testing.assert_allclose(got["scores"].numpy()[m],
                               np.asarray(want["scores"])[m], atol=1e-5)


def test_detector_forward_batch_statistics_f32_matches_jax(pair):
    want, want_decoded, new_state = pair["train"]
    with torch.no_grad():
        maps, strides = detector_maps(pair["detector"], pair["batch"],
                                      pair["cfg"], pair["bc"], training=True)
    assert strides == [7, 14]
    assert [tuple(m.shape) for m in maps[0]] == [(2, 4, 10, 14),
                                                 (2, 1, 10, 14),
                                                 (2, 2, 10, 14)]
    # the maps pass came first and moved the running statistics once, as
    # the reference's pass did
    bn = pair["detector"].head.scales[0].stem.bn
    np.testing.assert_allclose(
        bn.var.numpy(), np.asarray(new_state.head.scales[0].stem.bn.var),
        rtol=1e-4)
    bn = pair["detector"].head.cnn.scales[1].reg2.bn
    np.testing.assert_allclose(
        bn.mean.numpy(),
        np.asarray(new_state.head.cnn["scales"][1]["reg2"]["bn"]["mean"]),
        rtol=1e-4, atol=1e-6)
    # the same statistics again for the whole forward
    load_detector_state(pair["detector"], _np_tree(pair["params"]),
                        _np_tree(pair["state"]))
    with torch.no_grad():
        got, decoded = detector_forward(pair["detector"], pair["batch"],
                                        pair["cfg"], pair["bc"],
                                        training=True)
    _check_detections(got, want, decoded, want_decoded)


def test_detector_forward_eval_f32_matches_jax(pair):
    want, want_decoded, _ = pair["fwd"][False](
        pair["params"], pair["calibrated"], pair["jb"])
    load_detector_state(pair["detector"], _np_tree(pair["params"]),
                        _np_tree(pair["calibrated"]))
    got, decoded = detector_forward(pair["detector"], pair["batch"],
                                    pair["cfg"], pair["bc"])
    assert not decoded.requires_grad
    _check_detections(got, want, decoded, want_decoded)
    # eval mode leaves the running statistics alone
    bn = pair["detector"].head.scales[0].stem.bn
    np.testing.assert_array_equal(
        bn.var.numpy(),
        np.asarray(pair["calibrated"].head.scales[0].stem.bn.var))
    # without events the CNN head's maps stand alone
    no_ev, _ = detector_forward(pair["detector"], pair["batch"],
                                pair["cfg"], pair["bc"], no_events=True)
    assert no_ev["boxes"].shape == (2, 64, 4)
    assert not torch.equal(no_ev["scores"], got["scores"])


def test_detector_forward_bf16_within_reference_bounds(pair):
    """bf16 features, batch statistics, against the reference's f32 run:
    the bounds of tests/test_detector.py:75-79."""
    _, want_decoded, _ = pair["train"]
    load_detector_state(pair["detector"], _np_tree(pair["params"]),
                        _np_tree(pair["state"]))
    bc16 = pair["bc"]._replace(compute_dtype="bfloat16")
    for flags in ({}, dict(fused_two_block=False, fused_shift=False,
                           bilinear_kernel=True)):
        load_detector_state(pair["detector"], _np_tree(pair["params"]),
                            _np_tree(pair["state"]))
        with torch.no_grad():
            dets, decoded = detector_forward(
                pair["detector"], pair["batch"], pair["cfg"],
                bc16._replace(**flags), training=True)
        assert decoded.dtype == torch.float32
        assert torch.isfinite(decoded).all()
        assert torch.isfinite(dets["scores"]).all()
        d32, d16 = np.asarray(want_decoded), decoded.numpy()
        rel_xy = np.abs(d16[..., :2] - d32[..., :2]) \
            / (np.abs(d32[..., :2]) + 1.0)
        assert np.median(rel_xy) < 0.05, np.median(rel_xy)
        assert rel_xy.max() < 0.5, rel_xy.max()
        assert np.abs(d16[..., 4:] - d32[..., 4:]).max() < 0.3


def test_bf16_eval_flavours_agree_on_the_cpu(pair):
    """Eval mode in bf16: the generic flavour (K5's and K7's plain
    versions) against the default routing on the CPU, on calibrated
    statistics."""
    load_detector_state(pair["detector"], _np_tree(pair["params"]),
                        _np_tree(pair["calibrated"]))
    bc16 = pair["bc"]._replace(compute_dtype="bfloat16")
    with torch.no_grad():
        ref, _ = detector_maps(pair["detector"], pair["batch"], pair["cfg"],
                               bc16)
        gen, _ = detector_maps(
            pair["detector"], pair["batch"], pair["cfg"], bc16._replace(
                fused_two_block=False, fused_shift=False,
                bilinear_kernel=True))
    for a, b in zip(ref, gen):
        for m, r in zip(b, a):
            assert m.dtype == torch.bfloat16
            assert _rel(m, r.float().numpy()) < 0.15


def test_entry_points_run_on_the_cpu(pair, tmp_path, capsys):
    cfg = pair["cfg"].replace(seed=3)
    loader = synthetic_loader(cfg, 2, seed=5)
    ckpt = tmp_path / "detector.pt"
    torch.save({"model": pair["detector"].state_dict()}, ckpt)
    metrics = det_eval.evaluate(cfg.replace(test_checkpoint=str(ckpt)),
                                loader, device="cpu")
    assert set(metrics) == {"mAP", "mAP_50"}
    out = capsys.readouterr().out
    assert f"loaded {ckpt}" in out and "mAP@50" in out
    batch = pair["batch"]
    dt = bench_detector.bench(pair["detector"], batch, pair["cfg"],
                              pair["bc"], warmup=1, iters=2)
    assert dt > 0
