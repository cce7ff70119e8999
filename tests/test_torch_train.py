"""Head training of the port against the JAX package: gradients, the
optimizer, the train/eval steps as a whole, the plateau schedule,
checkpoints, the weight export back into JAX, the metrics (numpy only) and
the prediction collector.  Small fixture geometry, dropout off on both sides
(the two frameworks draw different random numbers from one seed)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventad_tpu.config import Config as JaxConfig
from eventad_tpu.data.synthetic import make_synthetic_batch as jax_batch
from eventad_tpu.models import dagr as jdagr
from eventad_tpu.models.convert import (convert_full_model, export_backbone,
                                        export_eventad_head)
from eventad_tpu.parallel import train_step as jts
from eventad_tpu.utils import evaluation as jev
from eventad_tpu.utils.predict import collect_predictions as jax_collect
from eventad_tpu_torch.config import Config
from eventad_tpu_torch.data.synthetic import (make_synthetic_batch,
                                              synthetic_loader)
from eventad_tpu_torch.models.convert import (export_reference_state,
                                              load_reference_state,
                                              split_reference_state)
from eventad_tpu_torch.models.dagr import (graph_static_config, init_model,
                                           model_forward)
from eventad_tpu_torch.parallel import train_step as tts
from eventad_tpu_torch.utils import checkpoint as ckpt
from eventad_tpu_torch.utils import evaluation as tev
from eventad_tpu_torch.utils.predict import collect_predictions

KW = dict(batch_size=2, use_image=False, width=96, height=72, scale=1,
          event_buckets=(4096,), graph_lookback=512)
OPT = dict(learning_rate=1e-3, weight_decay=1e-5, grad_clip=1.0)


def _jax_side():
    jcfg = JaxConfig(**KW)
    params, state, bc, mc = jdagr.init_model(jax.random.PRNGKey(0), jcfg)
    jb = jax_batch(jcfg, seed=3)._replace(pool_tables=None,
                                          search_starts=None, image_s2d=None)
    return (jcfg, params, state, bc, mc._replace(dropout=0.0),
            jax.tree.map(jnp.asarray, jb), jdagr.graph_static_config(jcfg))


def _torch_side(params, state, dtype="float32"):
    """The port's model with the JAX weights (through the reference
    checkpoint layout), its batch, optimizer and steps, on the CPU."""
    cfg = Config(**KW, compute_dtype=dtype)
    model, bc, mc = init_model(cfg, torch.Generator().manual_seed(1),
                               device="cpu")
    load_reference_state(
        model, export_backbone(params.dagr.backbone, state.dagr.backbone),
        export_eventad_head(params.head))
    gsc = graph_static_config(cfg)
    opt = tts.make_optimizer(model.head.parameters(), **OPT)
    fns = tts.make_train_fns(model, bc, mc, gsc, opt, device="cpu")
    return cfg, model, bc, mc, gsc, opt, fns, make_synthetic_batch(cfg,
                                                                   seed=3)


@pytest.fixture(scope="module")
def jax_f32():
    return _jax_side()


@pytest.fixture(scope="module")
def trained(jax_f32):
    """Three train steps on one batch in both packages (f32): the JAX loss
    trajectory and final parameters, and the port's model and steps."""
    jcfg, params, state, bc, mc, jb, jgsc = jax_f32
    side = _torch_side(params, state)
    opt = jts.make_optimizer(**OPT)
    fns = jts.make_train_fns(jcfg, bc, mc, jgsc, opt)
    p, s, o = jax.tree.map(jnp.copy, (params, state, opt.init(params.head)))
    jl, tl, finite = [], [], []
    for _ in range(3):
        p, s, o, m = fns.train_step(p, s, o, jb, jax.random.PRNGKey(1))
        jl.append(float(m["loss"]))
        tm = side[6].train_step(side[7])
        tl.append(float(tm["loss"]))
        finite.append(tm["finite"])
    return dict(jax_losses=jl, losses=tl, finite=finite, side=side,
                jax_params=p, jax_state=s, jax_eval=fns.eval_step)


def test_head_gradients_match_jax(jax_f32):
    jcfg, params, state, bc, mc, jb, jgsc = jax_f32

    def loss_fn(head):
        out, _ = jdagr.model_forward(
            jdagr.ModelParams(params.dagr, head), state, jb, bc, mc, jgsc,
            training=True, rng=None)
        return out.loss

    want_loss, want = jax.jit(jax.value_and_grad(loss_fn))(params.head)
    _, model, tbc, tmc, gsc, _, _, tb = _torch_side(params, state)
    out = model_forward(model, tb, tbc, tmc, gsc, training=True)
    out.loss.backward()
    assert abs(float(out.loss.detach()) - float(want_loss)) \
        <= 1e-5 * abs(float(want_loss))
    # the JAX gradient tree, laid out as the port's head parameters
    gmodel = init_model(Config(**KW), device="cpu")[0]
    load_reference_state(gmodel, split_reference_state(
        export_reference_state(model))[0], export_eventad_head(want))
    ref = dict(gmodel.head.named_parameters())
    for name, p in model.head.named_parameters():
        g = ref[name].detach()
        assert p.grad is not None, name
        assert (p.grad - g).abs().max() <= 1e-5 * g.abs().max() + 1e-12, name
    assert all(p.grad is None and not p.requires_grad
               for p in model.dagr.parameters())


def test_optimizer_matches_optax(rng):
    """The same gradients for 5 steps, their norm above the clip threshold
    in some steps and below it in others."""
    shapes = {"a": (7, 5), "b": (5,), "c": (3, 4)}
    p0 = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    scales = [30.0, 0.01, 4.0, 0.05, 0.2]
    grads = [{k: (sc * rng.randn(*s)).astype(np.float32)
              for k, s in shapes.items()} for sc in scales]
    norms = [np.sqrt(sum((g ** 2).sum() for g in gs.values()))
             for gs in grads]
    assert min(norms) < OPT["grad_clip"] < max(norms)

    opt = jts.make_optimizer(**OPT)
    jp = jax.tree.map(jnp.asarray, p0)
    state = opt.init(jp)
    import optax
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in p0.items()}
    topt = tts.make_optimizer(tp.values(), **OPT)
    for gs in grads:
        updates, state = opt.update(jax.tree.map(jnp.asarray, gs), state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(gs[k].copy())
        topt.step()
    for k in shapes:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    assert np.abs(tp["a"].detach().numpy() - p0["a"]).max() > 1e-3


def test_set_lr_scales_the_update(rng):
    p = torch.nn.Parameter(torch.ones(4))
    opt = tts.set_lr(tts.make_optimizer([p], 1e-3, 0.0, 1.0), 5e-4)
    p.grad = torch.full((4,), 0.1)
    opt.step()
    # first Adam step: |update| = lr * g / (|g| + eps)
    np.testing.assert_allclose(p.detach().numpy(), 1.0 - 5e-4, rtol=1e-6)


def test_train_steps_match_jax_f32(trained):
    jl, tl = trained["jax_losses"], trained["losses"]
    assert all(trained["finite"])
    for a, b in zip(tl, jl):
        assert abs(a - b) <= 1e-4 * abs(b), (tl, jl)
    assert tl[2] < tl[1] < tl[0], tl


def test_eval_step_matches_jax_after_training(trained):
    """After the three steps: the port's eval_step against the JAX one on
    the JAX-trained parameters."""
    _, jp, js = trained["jax_eval"], trained["jax_params"], \
        trained["jax_state"]
    side = trained["side"]
    logits, valid, labels, loss, n_valid = side[6].eval_step(side[7])
    jb = jax.tree.map(jnp.asarray, jax_batch(JaxConfig(**KW), seed=3)._replace(
        pool_tables=None, search_starts=None, image_s2d=None))
    want = trained["jax_eval"](jp, js, jb)
    v = np.asarray(want[1])
    np.testing.assert_array_equal(valid.numpy(), v)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want[2]))
    assert v.sum() >= 4 and int(n_valid) == int(want[4])
    assert not logits.requires_grad
    # three Adam steps apart: 1e-4 (slice tolerance) plus the steps' drift
    assert np.abs(logits.numpy()[v] - np.asarray(want[0])[v]).max() < 2e-4


def test_exported_head_loads_into_jax(trained, tmp_path):
    """A head trained by the port, saved by its checkpoint module, read back
    by the JAX package's torch converter: same logits."""
    _, model, bc, mc, gsc, opt, fns, tb = trained["side"]
    ckpt.save_model(tmp_path / "port.pt", model, opt)
    dagr_sd, _ = split_reference_state(export_reference_state(model))
    torch.save({"ema": {k: torch.from_numpy(v) for k, v in dagr_sd.items()}},
               tmp_path / "dagr.pth")
    jcfg = JaxConfig(**KW)
    params, state, jbc, jmc = convert_full_model(
        jcfg, str(tmp_path / "dagr.pth"), str(tmp_path / "port.pt"))
    jb = jax.tree.map(jnp.asarray, jax_batch(jcfg, seed=3)._replace(
        pool_tables=None, search_starts=None, image_s2d=None))
    want_logits, want_valid, *_ = trained["jax_eval"](params, state, jb)
    logits, valid, *_ = fns.eval_step(tb)
    v = np.asarray(want_valid)
    np.testing.assert_array_equal(valid.numpy(), v)
    assert np.abs(logits.numpy()[v] - np.asarray(want_logits)[v]).max() < 1e-4


def test_train_steps_bf16_within_band(jax_f32):
    """bf16 frozen features, f32 head: each step's loss within the 0.05
    logit band's consequence for a summed cross entropy (|dCE| <= 2 * 0.05
    per valid box), and descending."""
    jcfg, params, state, bc, mc, jb, jgsc = jax_f32
    bc = bc._replace(compute_dtype="bfloat16")
    _, model, tbc, tmc, gsc, topt, tfns, tb = _torch_side(params, state,
                                                          "bfloat16")
    opt = jts.make_optimizer(**OPT)
    fns = jts.make_train_fns(jcfg, bc, mc, jgsc, opt)
    p, s, o = jax.tree.map(jnp.copy, (params, state, opt.init(params.head)))
    tl = []
    for _ in range(3):
        p, s, o, m = fns.train_step(p, s, o, jb, jax.random.PRNGKey(1))
        tm = tfns.train_step(tb)
        assert tm["finite"] and int(tm["n_valid"]) == int(m["n_valid"])
        assert abs(float(tm["loss"]) - float(m["loss"])) \
            <= 2 * 0.05 * int(m["n_valid"])
        tl.append(float(tm["loss"]))
    assert tl[2] < tl[1] < tl[0], tl
    assert all(q.dtype == torch.float32 for q in model.head.parameters())


def test_non_finite_step_is_skipped(jax_f32):
    _, params, state, *_ = jax_f32
    _, model, _, _, _, opt, fns, tb = _torch_side(params, state)
    with torch.no_grad():
        model.head.fusion.fuse2_b[0] = float("nan")
    before = {k: v.clone() for k, v in model.head.state_dict().items()}
    m = fns.train_step(tb)
    assert m["finite"] is False and not np.isfinite(float(m["loss"]))
    for k, v in model.head.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), before[k].numpy(), k)
    assert not opt.state_dict()["state"]      # no Adam step was taken


def test_dropout_needs_training_and_generator(jax_f32):
    _, params, state, *_ = jax_f32
    _, model, bc, mc, gsc, _, _, tb = _torch_side(params, state)
    base = model_forward(model, tb, bc, mc, gsc).logits
    gen = torch.Generator().manual_seed(5)
    same = model_forward(model, tb, bc, mc, gsc, generator=gen).logits
    torch.testing.assert_close(same, base, rtol=0, atol=0)
    same = model_forward(model, tb, bc, mc, gsc, training=True).logits
    torch.testing.assert_close(same.detach(), base, rtol=0, atol=0)
    a = model_forward(model, tb, bc, mc, gsc, training=True,
                      generator=torch.Generator().manual_seed(5)).logits
    b = model_forward(model, tb, bc, mc, gsc, training=True,
                      generator=torch.Generator().manual_seed(5)).logits
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a.detach() - base).abs().max() > 1e-4


def test_plateau_matches_jax():
    losses = [1.0, 0.9, 0.95, 0.91, 0.9, 0.9, 0.9, 0.9, 0.89999, 0.9, 0.5,
              0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6, 0.6]
    a, b = tts.plateau_init(), jts.plateau_init()
    assert tuple(a) == tuple(b)
    scales = []
    for v in losses:
        a = tts.plateau_update(a, v, factor=0.5, patience=2)
        b = jts.plateau_update(b, v, factor=0.5, patience=2)
        assert tuple(a) == tuple(b)
        scales.append(a.scale)
    assert scales[-1] < scales[0] == 1.0


def test_checkpoint_round_trip(tmp_path, jax_f32):
    _, params, state, *_ = jax_f32
    _, model, bc, mc, gsc, opt, fns, tb = _torch_side(params, state)
    fns.train_step(tb)
    d = tmp_path / "models" / "exp_20260101_000000"
    ckpt.save_checkpoint(d, model, opt, 3, 0.9, 0.5, True, False)
    p = ckpt.find_best_checkpoint(str(tmp_path), "exp")
    assert p.name == "best_auc_model.pt"
    ckpt.save_checkpoint(d, model, opt, 4, 0.9, 0.6, False, True)
    p = ckpt.find_best_checkpoint(str(tmp_path), "exp")
    assert p.name == "best_ap_model.pt"
    assert str(ckpt.find_best_checkpoint(str(tmp_path), "exp",
                                         "/explicit.pt")) == "/explicit.pt"
    with pytest.raises(FileNotFoundError):
        ckpt.find_best_checkpoint(str(tmp_path), "other")

    other = init_model(Config(**KW), torch.Generator().manual_seed(9),
                       device="cpu")[0]
    oopt = tts.make_optimizer(other.head.parameters(), **OPT)
    extra = ckpt.load_checkpoint(d / "latest_checkpoint.pt", other, oopt,
                                 device="cpu")
    assert extra == dict(epoch=4, best_auc=0.9, best_ap=0.6)
    assert ckpt.load_extra(d / "best_auc_model.pt")["epoch"] == 3
    want = model.state_dict()
    for k, v in other.state_dict().items():
        assert v.device.type == "cpu"
        np.testing.assert_array_equal(v.numpy(), want[k].numpy(), k)
    for a, b in zip(oopt.state_dict()["state"].values(),
                    opt.state_dict()["state"].values()):
        for key in ("step", "exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(a[key].numpy(), b[key].numpy())
    # a model of another width refuses the file
    wide = init_model(Config(**{**KW, "h_dim": 128}), device="cpu")[0]
    with pytest.raises(ValueError):
        ckpt.load_checkpoint(d / "latest_checkpoint.pt", wide, device="cpu")
    with pytest.raises(RuntimeError):    # no card here: the default raises
        ckpt.load_checkpoint(d / "latest_checkpoint.pt", other)


def _scores_with_ties(rng, n):
    scores = np.round(rng.randn(n), 1)          # many ties
    labels = (rng.rand(n) < 0.3 + 0.2 * (scores > 0)).astype(np.float64)
    return labels, scores


@pytest.mark.parametrize("n", [50, 400])
def test_bbox_metrics_match_sklearn_backed(rng, n):
    labels, scores = _scores_with_ties(rng, n)
    got = tev.calculate_bbox_metrics(labels, scores)
    want = jev.calculate_bbox_metrics(labels, scores)
    assert set(got) == set(want)
    for k in want:
        assert abs(got[k] - want[k]) <= 1e-9, k
    empty = tev.calculate_bbox_metrics([], [])
    assert all(np.isnan(v) for v in empty.values())


def _videos(rng, n_videos=5, n_frames=30):
    frame_data, preds, first = {}, {}, {}
    for v in range(n_videos):
        vid = f"v{v}"
        toa = int(rng.randint(8, n_frames - 2))
        for f in range(n_frames):
            k = int(rng.randint(1, 4))
            sc = np.round(rng.rand(k) * (1.2 if f >= toa - 5 else 0.5), 1)
            lab = [float(f >= toa and rng.rand() > 0.3) for _ in range(k)]
            frame_data.setdefault(vid, {})[f] = {"scores": list(sc),
                                                 "labels": lab}
            preds.setdefault(vid, {})[f] = float(sc.max())
        first[vid] = toa
    return frame_data, preds, first


def test_frame_metrics_match(rng):
    frame_data, _, _ = _videos(rng)
    got = tev.calculate_frame_metrics(frame_data)
    want = jev.calculate_frame_metrics(frame_data)
    assert abs(got["auc_frame"] - want["auc_frame"]) <= 1e-9
    np.testing.assert_array_equal(got["frame_scores"], want["frame_scores"])
    np.testing.assert_array_equal(got["frame_labels"], want["frame_labels"])
    one_class = {"v": {0: {"scores": [0.1], "labels": [0.0]}}}
    assert np.isnan(tev.calculate_frame_metrics(one_class)["auc_frame"])


def test_tta_metrics_match(rng):
    _, preds, first = _videos(rng)
    toa = {"v0": first["v0"] + 2, "v1": "not a frame"}
    got = tev.calculate_tta_metrics(preds, first, toa)
    want = jev.calculate_tta_metrics(preds, first, toa)
    assert set(got) == set(want) and np.isfinite(got["mtta"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9,
                                   err_msg=k)


def test_response_metrics_match(rng):
    _, preds, _ = _videos(rng)
    got = tev.calculate_response_metrics(preds, fps=123.0)
    want = jev.calculate_response_metrics(preds, fps=123.0)
    assert set(got) == set(want) and np.isfinite(got["mresponse"])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-9,
                                   err_msg=k)


@pytest.mark.parametrize("collapse", [False, True])
def test_collect_predictions_matches_jax(rng, collapse):
    """The same fake forward over the port's synthetic loader (one batch
    made empty) through both collectors."""
    cfg = Config(**{**KW, "event_buckets": (256,)})
    loader = synthetic_loader(cfg, 5, seed=2, boxes_per_item=3)
    batch, meta = loader.items[1]
    loader.items[1] = (batch._replace(
        bbox_mask=torch.zeros_like(batch.bbox_mask)), meta)
    table = {}
    for i, (b, _) in enumerate(loader):
        table[id(b)] = (rng.randn(2, 31, 2).astype(np.float32),
                        b.box_present[:, 1].numpy(), b.box_labels.numpy())

    def forward(b):
        return table[id(b)]

    kw = dict(threshold=0.1, legacy_frame_collapse=collapse)
    got = collect_predictions(forward, loader, **kw)
    want = jax_collect(forward, loader, **kw)
    assert got["skipped_batch_count"] == 1 and got["valid_batch_count"] == 4
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v, k)
        else:
            assert got[k] == v, k
    assert len(got["video_predictions"]) == 3
