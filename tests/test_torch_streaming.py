"""Streaming inference of the port against the JAX package's
(``eventad_tpu/streaming``): the incremental step chunk by chunk with the
same weights and events (f32 with and without the image branch, bf16),
its pieces (``spline_conv(x_dst=)``, the full-resolution image rows,
``backbone_forward`` resumed at level 1, the search on the ring's inputs),
the ring mechanics, the stream against the port's own batch path, the
multi-chunk calls against single calls, the FLOP count and the bench's
entry point.  The JAX side runs its XLA formulation, jitted, once per
configuration and file, at its own tests' size
(``tests/test_streaming.py``: 48x36, 512 events, chunks of 128), and once
more at DoTA's shape (a 16:9 field at scale 4, chunks as long as the
lookback, ``configs/dota.yaml``'s relation)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventad_tpu.config import Config as JaxConfig
from eventad_tpu.models import dagr as jdagr
from eventad_tpu.models.backbone import backbone_forward as jax_backbone
from eventad_tpu.models.backbone import \
    make_backbone_config as jax_backbone_config
from eventad_tpu.models.convert import (export_backbone, export_cnn_branch,
                                        export_eventad_head)
from eventad_tpu.models.eventad import EventADConfig as JaxEventADConfig
from eventad_tpu.models.graph import Graph as JaxGraph
from eventad_tpu.models.graph import lookup_pixel_features as jax_lookup
from eventad_tpu.models.graph import upsample_align_corners as jax_upsample
from eventad_tpu.ops import event_graph as jeg
from eventad_tpu.ops.spline_conv import SplineConvParams
from eventad_tpu.ops.spline_conv import spline_conv as jax_spline_conv
from eventad_tpu.streaming import incremental as jinc
from eventad_tpu.streaming.evaluate import flops_report as jax_flops
from eventad_tpu_torch import bench_streaming
from eventad_tpu_torch.bench_streaming import main as bench_main
from eventad_tpu_torch.config import Config
from eventad_tpu_torch.models.backbone import backbone_forward
from eventad_tpu_torch.models.convert import load_reference_state
from eventad_tpu_torch.models.dagr import graph_static_config, init_model
from eventad_tpu_torch.models.graph import (Graph, lookup_pixel_features,
                                            upsample_align_corners)
from eventad_tpu_torch.ops import event_graph as teg
from eventad_tpu_torch.ops.spline_conv import SplineConv, spline_conv
from eventad_tpu_torch.streaming import incremental as inc
from eventad_tpu_torch.streaming.evaluate import (consistency_check,
                                                  flops_report)
from eventad_tpu_torch.streaming.runner import insert_events
from eventad_tpu_torch.streaming.state import init_streaming_state

import _torch_threads  # noqa: F401  (one intra-op thread)
from test_torch_event_graph import _kernel_mirror

KW = dict(batch_size=1, width=48, height=36, scale=1, event_buckets=(512,),
          graph_lookback=512)
N, N_CHUNK = 512, 128
# DoTA's shape: 64x36 at scale 4, chunks of 128 = the lookback, so that each
# destination's window reaches back across the whole previous chunk
KW_DOTA = dict(batch_size=1, width=256, height=144, scale=4,
               event_buckets=(512,), graph_lookback=128)
N_CHUNK_DOTA = 128
F32_TOL = 1e-5     # of scale (pieces) / absolute (logits), f32 both sides
BF16_TOL = 0.05    # logits, bf16 features (tests/test_bf16_path.py band)


def _events(seed, n=N, w=48, h=36, t_us=50_000):
    """Events as the JAX package's streaming tests draw them, on a ``w`` x
    ``h`` field over ``t_us`` microseconds."""
    rng = np.random.RandomState(seed)
    pos = np.zeros((n, 3), np.int32)
    pos[:, 0] = rng.randint(0, w, n)
    pos[:, 1] = rng.randint(0, h, n)
    pos[:, 2] = 1_000_000 + np.sort(rng.randint(0, t_us, n))
    pol = rng.choice([-1.0, 1.0], n).astype(np.float32)
    return pos, pol


def _frames(seed, m, s1=31):
    """``m`` frames of boxes, about half of the slots present (slot 0
    never)."""
    rng = np.random.RandomState(seed)
    boxes = rng.rand(m, s1, 4).astype(np.float32) * 20
    boxes[..., 2:] += 4
    present = rng.rand(m, s1) > 0.5
    present[:, 0] = False
    return boxes, present


def _t(a):
    return torch.from_numpy(np.array(a))


def _state_to_torch(st):
    """A JAX ``IncrementalState`` as the port's (CPU tensors)."""
    fields = {}
    for name in inc.IncrementalState._fields:
        v = getattr(st, name)
        if name == "image_feats" and v is not None:
            v = tuple(_t(f) for f in v)
        elif name == "cnn_maps" and v is not None:
            v = {k: [_t(m) for m in ms] for k, ms in v.items()}
        elif v is not None:
            v = _t(v)
        fields[name] = v
    return inc.IncrementalState(**fields)


def _scale_err(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() \
        / (np.abs(want).max() + 1e-12)


def seeded_tree(init, jcfg, seed=0):
    """The parameters and state that ``init(key, jcfg)`` returns first, of
    its shapes (traced, not run), filled from a numpy seed: weights at the
    scale of the package's initialisers, BN scales near 1, running
    variances positive (as ``tests/test_torch_detector.py`` fills the
    detector)."""
    shapes = jax.eval_shape(lambda k: init(k, jcfg)[:2],
                            jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name = next(str(getattr(k, "name", getattr(k, "key", "")))
                    for k in reversed(path) if not hasattr(k, "idx"))
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


def _models(use_image, kw=KW):
    """The JAX model's parameters from a numpy seed and the port's model
    with the same weights."""
    jcfg = JaxConfig(**kw, use_image=use_image)
    params, state = seeded_tree(jdagr.init_model, jcfg)
    jbc = jax_backbone_config(jcfg)
    jmc = JaxEventADConfig(x_dim=jcfg.x_dim, h_dim=jcfg.h_dim,
                           max_boxes=jcfg.max_boxes)
    sd = export_backbone(params.dagr.backbone, state.dagr.backbone)
    if use_image:
        sd.update(export_cnn_branch(params.dagr.cnn, state.dagr.cnn))
    cfg = Config(**kw, use_image=use_image)
    model, bc, mc = init_model(cfg, torch.Generator().manual_seed(1),
                               device="cpu")
    load_reference_state(model, sd, export_eventad_head(params.head))
    return (jcfg, params, state, jbc, jmc), (cfg, model, bc, mc)


def _jax_stream(jx, dtype, pos, pol, boxes, present, image,
                n_chunk=N_CHUNK):
    """The JAX package's incremental stream: the first chunk inserted raw
    and refreshed, then one step per further chunk with that step's frame
    of boxes; returns the state after the refresh, the logits of every
    step and the last state."""
    jcfg, params, state, bc, mc = jx
    bc = bc._replace(compute_dtype=dtype)
    gsc = jdagr.graph_static_config(jcfg)
    refresh, step = jinc.make_incremental_step(params, state, bc, mc, gsc,
                                               n_chunk=n_chunk, n_buf=N)
    st = jinc.init_incremental_state(N, bc, mc,
                                     max_neighbors=jcfg.max_neighbors)
    if bc.use_image:
        st = jax.jit(lambda p, s, st, im: jinc.update_image(
            p, s, st, im, jcfg.img_net))(params, state, st,
                                         jnp.asarray(image))
    st = jinc.insert_raw(st, jnp.asarray(pos[:n_chunk]),
                         jnp.asarray(pol[:n_chunk]), jnp.int32(n_chunk))
    st = refresh(st)
    refreshed = st
    logits = []
    for ci in range(1, N // n_chunk):
        lo, hi = ci * n_chunk, (ci + 1) * n_chunk
        st, lg = step(st, jnp.asarray(pos[lo:hi]), jnp.asarray(pol[lo:hi]),
                      jnp.int32(n_chunk), jnp.asarray(boxes[ci]),
                      jnp.asarray(present[ci]))
        logits.append(np.asarray(lg))
    return refreshed, logits, st


def _port_stream(tx, dtype, pos, pol, boxes, present, image,
                 n_chunk=N_CHUNK):
    cfg, model, bc, mc = tx
    bc = bc._replace(compute_dtype=dtype)
    refresh, step = inc.make_incremental_step(
        model, bc, mc, graph_static_config(cfg), n_chunk=n_chunk, n_buf=N)
    st = inc.init_incremental_state(N, bc, mc, device="cpu")
    if bc.use_image:
        st = inc.update_image(model, st, _t(image))
    st = inc.insert_raw(st, _t(pos[:n_chunk]), _t(pol[:n_chunk]), n_chunk)
    st = refresh(st)
    refreshed = st
    logits = []
    for ci in range(1, N // n_chunk):
        lo, hi = ci * n_chunk, (ci + 1) * n_chunk
        st, lg = step(st, _t(pos[lo:hi]), _t(pol[lo:hi]), n_chunk,
                      _t(boxes[ci]), _t(present[ci]))
        logits.append(lg.numpy())
    return refreshed, logits, (refresh, step, st)


@pytest.fixture(scope="module", params=[False, True],
                ids=["events", "image"])
def pair(request):
    """Both models, one JAX run of the stream in f32 (in bf16 too without
    the image branch) and the port's run of the same stream."""
    use_image = request.param
    jx, tx = _models(use_image)
    pos, pol = _events(0)
    boxes, present = _frames(1, N // N_CHUNK)
    image = np.random.RandomState(2).rand(36, 48, 3).astype(np.float32)
    args = (pos, pol, boxes, present, image)
    runs = {"float32": (_jax_stream(jx, "float32", *args),
                        _port_stream(tx, "float32", *args))}
    if not use_image:
        runs["bfloat16"] = (_jax_stream(jx, "bfloat16", *args),
                            _port_stream(tx, "bfloat16", *args))
    return dict(jax=jx, torch=tx, args=args, runs=runs)


@pytest.fixture(scope="module")
def pair_dota():
    """Both models at DoTA's shape with the image branch, and one JAX and
    one port run of the same f32 stream."""
    jx, tx = _models(True, KW_DOTA)
    # dense, as DoTA's stream is: a chunk spans 1.25 ms of the graph's 10 ms
    # and falls on 16x12 pixels, so the lookback, not the time radius,
    # bounds each destination's window
    pos, pol = _events(7, w=16, h=12, t_us=5_000)
    boxes, present = _frames(8, N // N_CHUNK_DOTA)
    image = np.random.RandomState(9).rand(36, 64, 3).astype(np.float32)
    args = (pos, pol, boxes, present, image)
    runs = {"float32": (_jax_stream(jx, "float32", *args, N_CHUNK_DOTA),
                        _port_stream(tx, "float32", *args, N_CHUNK_DOTA))}
    return dict(jax=jx, torch=tx, args=args, runs=runs)


def _assert_stream_matches(pair, n_chunk):
    for dtype, ((jst, jlogits, jend), (tst, tlogits, (_, _, tend))) in \
            pair["runs"].items():
        tol = F32_TOL if dtype == "float32" else BF16_TOL
        present = pair["args"][3]
        for ci, (j, t) in enumerate(zip(jlogits, tlogits), start=1):
            assert np.isfinite(t).all()
            np.testing.assert_array_equal(t[~present[ci]], 0.0)
            d = np.abs(t - j).max()
            assert d < tol, (dtype, ci, d)
        assert present[1:].sum() >= 20
        for name in ("nbr0", "nbrm0", "off0", "valid", "pos"):
            np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                          np.asarray(getattr(jst, name)),
                                          err_msg=name)
        assert int(tst.valid.sum()) == n_chunk
        for name in ("x_in", "h_b1", "h1", "img1"):
            assert _scale_err(getattr(tst, name).numpy(),
                              getattr(jst, name)) < F32_TOL, name
        # the appends' tail searches: the last state's graph
        for name in ("nbr0", "nbrm0", "off0", "valid", "pos"):
            np.testing.assert_array_equal(getattr(tend, name).numpy(),
                                          np.asarray(getattr(jend, name)),
                                          err_msg=name)
        assert int(tend.nbrm0.sum()) > 0


def test_incremental_step_matches_jax(pair):
    """The logits of every step (different boxes each frame, so the
    recurrent state carries), the caches after the refresh of a ring whose
    invalid rows come first and the graph after the last append."""
    _assert_stream_matches(pair, N_CHUNK)


def test_incremental_step_matches_jax_chunk_as_long_as_lookback(pair_dota):
    """As above at DoTA's shape: the append's search over ``lookback +
    chunk`` tail rows with every destination's window reaching back across
    the whole previous chunk, and the image maps of a 16:9 frame."""
    _assert_stream_matches(pair_dota, N_CHUNK_DOTA)


def test_incremental_generic_flavour_in_bf16(pair):
    """The bf16 stream in the ``base`` flavour (``fused_two_block`` and
    ``fused_shift`` off), whose pooled levels run the generic conv K5 (its
    plain version here) on the neighbour positions the pooling hands on,
    as K3 does on the card: within the bf16 band of the JAX package's f32
    stream."""
    cfg, model, bc, mc = pair["torch"]
    base = (cfg, model, bc._replace(fused_two_block=False,
                                    fused_shift=False), mc)
    _, logits, _ = _port_stream(base, "bfloat16", *pair["args"])
    want = pair["runs"]["float32"][0][1]
    for got, w in zip(logits, want):
        assert np.isfinite(got).all()
        assert np.abs(got - w).max() < BF16_TOL


def test_backbone_resumed_at_level1_matches_jax(pair):
    """``backbone_forward(start_level=1)`` from the refreshed caches, with
    the first pooling's source positions given (K columns, the self slot
    included) and without them (read through ``nbr``), and stopped early
    (``end_level``), against the JAX package's on the same graph."""
    jcfg, params, state, jbc, _ = pair["jax"]
    cfg, model, bc, _ = pair["torch"]
    jst = pair["runs"]["float32"][0][0]
    tst = _state_to_torch(jst)
    gsc = graph_static_config(cfg)
    posn = inc.norm_pos(tst.pos, tst.t_now, gsc)
    jposn = jinc._norm_pos(jst.pos, jst.t_now, jdagr.graph_static_config(
        jcfg))
    np.testing.assert_array_equal(posn.numpy(), np.asarray(jposn))
    x1 = torch.cat([tst.h1, tst.img1], 1) if bc.use_image else tst.h1
    g = Graph(x1, posn, tst.nbr0, tst.nbrm0, tst.valid,
              torch.zeros(N, dtype=torch.int32))
    jg = JaxGraph(*(jnp.asarray(a.numpy()) for a in g[:6]))
    pos_src0 = (tst.pos[:, None, :2] - tst.off0).to(torch.float32) \
        / torch.tensor([48.0, 36.0])
    cases = (pos_src0, None)

    @jax.jit
    def jax_cases(p, s, jg, feats, ps):
        return [jax_backbone(p, s, jg, feats, jbc, start_level=1,
                             pos_src0=None if src is None else ps)[0]
                for src in cases]
    wants = jax_cases(params.dagr.backbone, state.dagr.backbone, jg,
                      jst.image_feats, jnp.asarray(pos_src0.numpy()))
    for src, want in zip(cases, wants):
        got = backbone_forward(model.dagr.backbone, g, tst.image_feats, bc,
                               start_level=1, pos_src0=src)
        assert len(got) == len(want) == 2
        for tg, wg in zip(got, want):
            assert _scale_err(tg.x.numpy(), wg.x) < F32_TOL
            np.testing.assert_array_equal(tg.nbr_mask.numpy(),
                                          np.asarray(wg.nbr_mask))
            assert tg.node_mask.sum() > 0
    # stopped early: the graphs of the levels reached
    out3 = backbone_forward(model.dagr.backbone, g, tst.image_feats, bc,
                            start_level=1, pos_src0=pos_src0, end_level=4)
    assert len(out3) == 1 and torch.equal(out3[0].x, got[0].x)
    (g2,) = backbone_forward(model.dagr.backbone, g, tst.image_feats, bc,
                             start_level=1, pos_src0=pos_src0, end_level=3)
    assert g2.x.shape[0] == np.prod(bc.grids[1])


def test_append_many_and_step_many_equal_single_calls(pair):
    """``append_many`` and ``step.many`` (loops over chunks) equal the same
    chunks through single calls, bit for bit, state and logits."""
    _, _, (_, step, st) = pair["runs"]["float32"][1]
    m = 3
    pos, pol = _events(5, m * N_CHUNK)
    pos[:, 2] += 60_000
    chunks, pols = _t(pos.reshape(m, N_CHUNK, 3)), _t(pol.reshape(m, -1))
    counts = torch.tensor([N_CHUNK, 77, N_CHUNK], dtype=torch.int32)
    boxes, present = (_t(a) for a in _frames(6, m))
    seq_a, seq_s, seq_logits = st, st, []
    for j in range(m):
        seq_a = step.append(seq_a, chunks[j], pols[j], counts[j])
        seq_s, lg = step(seq_s, chunks[j], pols[j], counts[j], boxes[j],
                         present[j])
        seq_logits.append(lg)
    many_a = step.append_many(st, chunks, pols, counts)
    many_s, many_logits = step.many(st, chunks, pols, counts, boxes,
                                    present)
    assert torch.equal(many_logits, torch.stack(seq_logits))
    assert bool((many_logits != 0).any())
    for a, b in ((seq_a, many_a), (seq_s, many_s)):
        for name in inc.IncrementalState._fields:
            x, y = getattr(a, name), getattr(b, name)
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), name


def test_port_stream_matches_port_batch(pair):
    """The port's dense stream (``consistency_check``) and its incremental
    stream end on the logits of its batch path over the same window, within
    1e-5 (``tests/test_streaming.py:57`` holds the JAX package so)."""
    cfg, model, bc, mc = pair["torch"]
    pos, pol = _events(3)
    s1 = cfg.max_boxes + 1
    boxes = np.zeros((s1, 4), np.float32)
    present = np.zeros((s1,), bool)
    boxes[1], boxes[2] = (5, 5, 20, 15), (25, 12, 15, 15)
    present[1] = present[2] = True
    diff, batch_logits, stream_logits = consistency_check(
        model, cfg, pos, pol, boxes, present, n_chunks=4)
    assert diff < F32_TOL, diff
    assert torch.isfinite(batch_logits).all()

    refresh, step = inc.make_incremental_step(
        model, bc, mc, graph_static_config(cfg), n_chunk=N_CHUNK, n_buf=N)
    st = inc.init_incremental_state(N, bc, mc, device="cpu")
    if bc.use_image:
        st = inc.update_image(model, st, torch.zeros(36, 48, 3))
    st = refresh(inc.insert_raw(st, _t(pos[:N_CHUNK]), _t(pol[:N_CHUNK]),
                                N_CHUNK))
    no_boxes, no_present = torch.zeros(s1, 4), torch.zeros(s1, dtype=bool)
    for ci in range(1, N // N_CHUNK):
        lo, hi = ci * N_CHUNK, (ci + 1) * N_CHUNK
        last = hi == N
        st, logits = step(st, _t(pos[lo:hi]), _t(pol[lo:hi]), N_CHUNK,
                          _t(boxes) if last else no_boxes,
                          _t(present) if last else no_present)
    d = (logits[_t(present)] - batch_logits[_t(present)]).abs().max()
    assert d < F32_TOL, d


def test_insert_events_ring():
    """``tests/test_streaming.py::test_insert_events_ring`` on the port."""
    st = init_streaming_state(n_buf=8, max_boxes=4, device="cpu")
    pos = torch.tensor([[1, 1, 10], [2, 2, 20], [3, 3, 30]],
                       dtype=torch.int32)
    pol = torch.ones(3)
    st = insert_events(st, pos, pol, 3)
    assert int(st.valid.sum()) == 3
    assert int(st.t_now) == 30
    # partial chunk: only the first 2 of 3 slots valid
    st = insert_events(st, pos + 100, pol, torch.tensor(2))
    assert int(st.valid.sum()) == 5
    assert int(st.pos[st.valid][-1, 2]) == 120   # newest at the end
    # overflow evicts the oldest
    big = torch.from_numpy(np.stack([np.arange(8), np.arange(8),
                                     np.arange(8) + 1000], 1).astype(
                                         np.int32))
    st = insert_events(st, big, torch.ones(8), 8)
    assert int(st.valid.sum()) == 8
    assert int(st.pos[:, 2].max()) == 1007
    np.testing.assert_array_equal(st.pos.numpy(), big.numpy())


def test_streaming_states_default_to_the_card():
    """Without a CUDA device the streaming states are made on the CPU only
    when the caller names it; nothing falls back silently."""
    cfg = Config(**KW, use_image=False)
    model, bc, mc = init_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_streaming_state(64, mc.max_boxes)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        inc.init_incremental_state(64, bc, mc)
    st = inc.init_incremental_state(64, bc, mc, device="cpu")
    assert st.h1.device.type == "cpu" and st.x_in.shape == (64, 3)


def test_headless_step_refuses_head_entry_points(pair):
    """``mc=None`` (the streaming detector's mode): append works, the head's
    entry points raise."""
    cfg, model, bc, mc = pair["torch"]
    refresh, step = inc.make_incremental_step(
        model, bc, None, graph_static_config(cfg), n_chunk=64, n_buf=256)
    st = inc.init_incremental_state(256, bc, mc, device="cpu")
    if bc.use_image:
        st = inc.update_image(model, st, torch.zeros(36, 48, 3))
    pos = torch.zeros((64, 3), dtype=torch.int32)
    pos[:, 2] = 1_000_000
    st = step.append(st, pos, torch.ones(64), 64)
    assert int(st.valid.sum()) == 64
    boxes, present = torch.zeros(31, 4), torch.zeros(31, dtype=bool)
    for call in (lambda: step.read_scores(st, boxes, present),
                 lambda: step(st, pos, torch.ones(64), 64, boxes, present),
                 lambda: step.many(st, pos[None], torch.ones(1, 64),
                                   torch.tensor([64]), boxes[None],
                                   present[None])):
        with pytest.raises(RuntimeError, match="without an anomaly-head"):
            call()


def test_spline_conv_x_dst_matches_jax():
    """Destinations a subset of the gather source (the incremental
    level-0 rows): the root product and the folded self edge take
    ``x_dst``."""
    rng = np.random.RandomState(7)
    n, nd, k, cin, cout = 300, 40, 15, 9, 16
    x = rng.randn(n, cin).astype(np.float32)
    x_dst = x[-nd:]
    nbr = rng.randint(0, n, (nd, k)).astype(np.int32)
    nbr_mask = rng.rand(nd, k) > 0.3
    attr = (0.5 + 0.05 * rng.randn(nd, k, 2)).astype(np.float32)
    conv = SplineConv(cin, cout, 5, torch.Generator().manual_seed(3))
    conv.root.data.normal_(generator=torch.Generator().manual_seed(4))
    p = SplineConvParams(weight=jnp.asarray(conv.weight.detach().numpy()),
                         root=jnp.asarray(conv.root.detach().numpy()),
                         bias=None)
    arange = ((0.4, 0.6), (0.4, 0.6))
    for kw in ({}, dict(attr_range=arange, add_center_to_root=True)):
        got = spline_conv(_t(x), _t(nbr), _t(nbr_mask), _t(attr), conv,
                          kernel_size=5, x_dst=_t(x_dst), **kw)
        want = jax_spline_conv(jnp.asarray(x), jnp.asarray(nbr),
                               jnp.asarray(nbr_mask), jnp.asarray(attr), p,
                               kernel_size=5, x_dst=jnp.asarray(x_dst), **kw)
        assert got.shape == (nd, cout)
        assert _scale_err(got.detach().numpy(), want) < F32_TOL, kw
    # without x_dst the destinations are x itself
    full = spline_conv(_t(x[-nd:]), _t(nbr % nd), _t(nbr_mask), _t(attr),
                       conv, kernel_size=5)
    same = spline_conv(_t(x[-nd:]), _t(nbr % nd), _t(nbr_mask), _t(attr),
                       conv, kernel_size=5, x_dst=_t(x[-nd:]))
    assert torch.equal(full, same)


def test_full_resolution_image_rows_match_jax():
    """``upsample_align_corners`` and ``lookup_pixel_features`` (the
    incremental path's image rows) against the JAX package's, and their
    composition against the batch path's ``upsample_lookup``."""
    from eventad_tpu_torch.models.graph import upsample_lookup
    rng = np.random.RandomState(8)
    feat = rng.randn(1, 9, 12, 5).astype(np.float32)
    up = upsample_align_corners(_t(feat), 48, 36)
    jup = jax_upsample(jnp.asarray(feat), 48, 36)
    assert up.shape == (1, 36, 48, 5)
    assert _scale_err(up.numpy(), jup) < F32_TOL
    pos = np.stack([rng.randint(0, 48, 200) / np.float32(48),
                    rng.randint(0, 36, 200) / np.float32(36),
                    rng.rand(200)], 1).astype(np.float32)
    mask = rng.rand(200) > 0.2
    batch = np.zeros(200, np.int32)
    got = lookup_pixel_features(up, _t(pos), _t(batch), _t(mask), 48, 36)
    want = jax_lookup(jup, jnp.asarray(pos), jnp.asarray(batch),
                      jnp.asarray(mask), 48, 36)
    assert _scale_err(got.numpy(), want) < F32_TOL
    np.testing.assert_array_equal(got.numpy()[~mask], 0.0)
    rows = upsample_lookup([_t(feat)], _t(pos), _t(batch), _t(mask), 48, 36)
    assert torch.equal(rows, got)


@pytest.mark.parametrize("kind", ["filling", "tail"])
def test_search_on_ring_inputs(kind):
    """The searches the incremental path makes: the refresh of a ring still
    filling (invalid rows first, t = 0, then absolute times about 10^6 us)
    and an append's tail (``lookback + n_chunk`` rows, absolute times).
    ``build_graph_auto`` with the TPU kernel's knobs (``chunk=16``,
    ``grid_wh``) equals the call without them and the JAX package's
    ``build_graph_auto``, and the numpy mirror of K1's scan equals them:
    exactly."""
    pos, _ = _events(4, 1536)
    valid = np.ones(1536, bool)
    lookback = 1024
    if kind == "filling":
        valid[:1000] = False
        pos[:1000] = 0
        lookback = 1536
    kw = dict(radius=2, delta_t_us=10_000, max_neighbors=16,
              max_queue_size=128, lookback=lookback)
    p, v = _t(pos[None]), _t(valid[None])
    got = teg.build_graph_auto(p, v, chunk=16, grid_wh=(48, 36), **kw)
    plain = teg.build_graph_auto(p, v, **kw)
    want = jeg.build_graph_auto(jnp.asarray(pos[None]),
                                jnp.asarray(valid[None]), chunk=16,
                                grid_wh=(48, 36), **kw)
    ranks = teg._ranks_or_default(p, v, None).numpy()
    mirror = _kernel_mirror(pos[None], valid[None], ranks, **kw)
    for g, pl, w, mi in zip(got, plain, want, mirror):
        assert torch.equal(g, pl)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(g.numpy(), mi)
    tiles = valid.reshape(-1, 128).any(1)
    assert mirror[3][0, tiles].all()    # every tile with events proves
    assert got[1][..., 1:].sum() > 500


def test_build_graph_auto_hands_the_kernel_no_tiling_knobs(monkeypatch):
    """On the card the dispatch calls K1's wrapper without the TPU
    kernel's knobs (``grid_wh``, ``chunk``, ``starts``), which it does not
    take; on the CPU the plain version gets its own ``chunk`` and not
    ``grid_wh``.  The search's own arguments pass through."""
    calls = []
    monkeypatch.setattr(teg, "build_graph_cuda",
                        lambda *a, **kw: calls.append((a, kw)) or "k1")
    monkeypatch.setattr(teg, "build_graph",
                        lambda *a, **kw: calls.append((a, kw)) or "plain")

    class OnTheCard:
        is_cuda = True

    class OnTheCpu:
        is_cuda = False
    search = dict(radius=2, delta_t_us=10_000, lookback=64)
    card, cpu = OnTheCard(), OnTheCpu()
    assert teg.build_graph_auto(card, "valid", None, chunk=16,
                                grid_wh=(48, 36), starts="s",
                                **search) == "k1"
    assert teg.build_graph_auto(cpu, "valid", None, chunk=16,
                                grid_wh=(48, 36), **search) == "plain"
    assert calls == [((card, "valid", None), search),
                     ((cpu, "valid", None), dict(search, chunk=16))]


def test_flops_report_equals_jax():
    for kw, n, changed in ((KW, 4096, 64), ({}, 16384, 512)):
        got = flops_report(Config(**kw), n, changed)
        want = jax_flops(JaxConfig(**kw), n, changed)
        assert got == want


def test_bench_streaming_on_the_cpu(capsys):
    """The entry point at a small size on the CPU prints one JSON line with
    the JAX bench's keys; without a card and without ``--device cpu`` it
    raises."""
    import json
    res = bench_main(["128", "float32", "--device", "cpu", "--width", "48",
                      "--height", "36", "--scale", "1", "--n_buf", "512",
                      "--iters", "2", "--graph_lookback", "256"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "cpu" and json.loads(lines[-1]) == res
    for key in ("value", "p99_ms", "append_p50_ms", "refresh_ms",
                "device_read_ms", "device_read_detections_ms",
                "device_append_scan_ms", "device_step_scan_ms",
                "dense_mflops", "delta_mflops", "flop_ratio"):
        assert np.isfinite(res[key]) and res[key] > 0, key
    assert res["metric"] == "streaming_p50_latency_ms"
    assert res["events_per_chunk"] == 128
    # the device-time keys come from the card only
    assert not set(bench_streaming.CARD_KEYS) & set(res)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_main(["128"])
