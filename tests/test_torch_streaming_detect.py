"""The streaming detection read-out of the port against the JAX package's
(``eventad_tpu/streaming/detect.py``) and against the port's own batch
``detector_forward`` on the same window, at the JAX test's size
(``tests/test_streaming_detect.py``: 48x36, 512 events, chunks of 128, the
image branch on).  The detector's weights are the JAX package's parameter
shapes filled from a numpy seed; the JAX side runs jitted, once."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventad_tpu.config import Config as JaxConfig
from eventad_tpu.models import detector as jdet
from eventad_tpu.models.backbone import \
    make_backbone_config as jax_backbone_config
from eventad_tpu.models.dagr import graph_static_config as jax_gsc
from eventad_tpu.models.eventad import EventADConfig as JaxEventADConfig
from eventad_tpu.streaming import detect as jsd
from eventad_tpu.streaming import incremental as jinc
from eventad_tpu_torch.config import Config
from eventad_tpu_torch.models.convert import load_detector_state
from eventad_tpu_torch.models.dagr import graph_static_config
from eventad_tpu_torch.models.detector import detector_forward, init_detector
from eventad_tpu_torch.models.eventad import EventADConfig
from eventad_tpu_torch.streaming import incremental as inc
from eventad_tpu_torch.streaming.detect import (make_incremental_detector,
                                                update_image_detector)

import _torch_threads  # noqa: F401  (one intra-op thread)
from test_torch_streaming import N, N_CHUNK, _events, _t, seeded_tree

KW = dict(batch_size=1, width=48, height=36, scale=1, use_image=True,
          event_buckets=(512,), graph_lookback=512)
TOL = 1e-5   # of the largest |value|, f32 both sides (the JAX test's bound)


def _scale_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.fixture(scope="module")
def runs():
    """The JAX package's stream and the port's over the same events, frame
    and weights: update_image_detector, the first chunk inserted raw and
    refreshed, three appends, then read_detections."""
    jcfg, cfg = JaxConfig(**KW), Config(**KW)
    params, state = seeded_tree(jdet.init_detector, jcfg)
    jbc = jax_backbone_config(jcfg)
    pos, pol = _events(0)
    image = np.random.RandomState(2).rand(36, 48, 3).astype(np.float32)
    # random weights on their initial running statistics overflow the
    # exp of the box decode (tests/test_detector.py:20-22): the running
    # statistics are set to this window's batch statistics, worked out from
    # the state one batch-statistics pass returns (momentum 0.1)
    new_state = jax.jit(lambda p, s, ev, po, im: jdet.detector_forward(
        p, s, SimpleNamespace(pos=ev, polarity=po, image=im,
                              valid=jnp.ones((1, N), bool)),
        jcfg, jbc, training=True)[2])(
        params, state, jnp.asarray(pos)[None], jnp.asarray(pol)[None],
        jnp.asarray(image)[None])
    state = jax.tree.map(lambda new, old: (new - 0.9 * old) / 0.1,
                         new_state, state)
    detector, bc = init_detector(cfg, torch.Generator().manual_seed(1),
                                 "cpu")
    load_detector_state(detector, jax.tree.map(np.asarray, params),
                        jax.tree.map(np.asarray, state))

    refresh, append, read_det = jsd.make_incremental_detector(
        params, state, jbc, jax_gsc(jcfg), n_chunk=N_CHUNK, n_buf=N)
    jst = jinc.init_incremental_state(N, jbc, JaxEventADConfig(),
                                      max_neighbors=jcfg.max_neighbors)
    jst = jax.jit(lambda p, s, st, im: jsd.update_image_detector(
        p, s, st, im, jbc, jcfg.img_net))(params, state, jst,
                                          jnp.asarray(image))
    framed = jst
    jst = refresh(jinc.insert_raw(jst, jnp.asarray(pos[:N_CHUNK]),
                                  jnp.asarray(pol[:N_CHUNK]),
                                  jnp.int32(N_CHUNK)))
    for lo in range(N_CHUNK, N, N_CHUNK):
        jst = append(jst, jnp.asarray(pos[lo:lo + N_CHUNK]),
                     jnp.asarray(pol[lo:lo + N_CHUNK]), jnp.int32(N_CHUNK))
    jdets, jdecoded = read_det(jst)

    t_refresh, t_step = make_incremental_detector(
        detector, bc, graph_static_config(cfg), n_chunk=N_CHUNK, n_buf=N)
    tst = inc.init_incremental_state(N, bc, EventADConfig(), device="cpu")
    tst = update_image_detector(detector, tst, _t(image), bc)
    t_framed = tst
    tst = t_refresh(inc.insert_raw(tst, _t(pos[:N_CHUNK]),
                                   _t(pol[:N_CHUNK]), N_CHUNK))
    for lo in range(N_CHUNK, N, N_CHUNK):
        tst, (tdets, tdecoded) = t_step(tst, _t(pos[lo:lo + N_CHUNK]),
                                        _t(pol[lo:lo + N_CHUNK]), N_CHUNK)
    batch = SimpleNamespace(pos=_t(pos)[None], polarity=_t(pol)[None],
                            valid=torch.ones((1, N), dtype=torch.bool),
                            rank=None, image=_t(image)[None])
    bdets, bdecoded = detector_forward(detector, batch, cfg, bc)
    return dict(jax=(framed, jdets, jdecoded), port=(t_framed, tdets,
                                                     tdecoded),
                batch=(bdets, bdecoded))


def _check(dets, decoded, want_dets, want_decoded):
    assert decoded.shape == np.shape(want_decoded)
    assert decoded.shape[0] == 1 and decoded.shape[2] == 7
    assert torch.isfinite(decoded).all()
    err = _scale_err(decoded.numpy(), want_decoded)
    assert err < TOL, err
    mask = np.asarray(want_dets["mask"][0])
    assert mask.sum() > 0
    np.testing.assert_array_equal(dets["mask"][0].numpy(), mask)
    np.testing.assert_allclose(dets["scores"][0].numpy()[mask],
                               np.asarray(want_dets["scores"][0])[mask],
                               rtol=1e-4, atol=1e-5)
    for key, shape in (("boxes", (1, 64, 4)), ("scores", (1, 64)),
                       ("labels", (1, 64)), ("mask", (1, 64))):
        assert tuple(dets[key].shape) == shape, key


def test_read_detections_match_jax(runs):
    _, jdets, jdecoded = runs["jax"]
    _, tdets, tdecoded = runs["port"]
    _check(tdets, tdecoded, jdets, jdecoded)


def test_read_detections_match_port_batch(runs):
    """The stream ends on the batch ``detector_forward`` of the same
    window (the consistency contract of the reference's asynchronous
    runtime)."""
    _, tdets, tdecoded = runs["port"]
    bdets, bdecoded = runs["batch"]
    _check(tdets, tdecoded, bdets, bdecoded.numpy())


def test_update_image_detector_matches_jax(runs):
    """The per-frame CNN work: maps 0 and 1 upsampled to full resolution,
    the others as the CNN gives them, and the CNN head's logit maps."""
    jst, tst = runs["jax"][0], runs["port"][0]
    assert tst.image_feats[0].shape == (1, 36, 48, 16)
    for got, want in zip(tst.image_feats, jst.image_feats):
        d = np.abs(got.numpy() - np.asarray(want)).max()
        assert d <= TOL * np.abs(np.asarray(want)).max(), d
    for key, maps in tst.cnn_maps.items():
        for got, want in zip(maps, jst.cnn_maps[key]):
            want = np.asarray(want)
            assert got.shape == want.shape
            assert np.abs(got.numpy() - want).max() \
                <= TOL * np.abs(want).max(), key
