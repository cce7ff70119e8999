"""The port's parallelism over torch.distributed (``eventad_tpu_torch/
parallel/``) against its single-process steps and the JAX package's sharded
step: the counterparts of ``tests/test_parallel.py``'s six tests.

One spawn of 4 gloo processes (``_torch_dist.mesh_and_steps``) gives the
mesh shapes and the degrade rule, the head's data-parallel train and eval
steps on a 2x2 mesh and two dp x tp detector steps on it; this process runs
the same cases without a mesh, and the JAX package's 2-device sharded head
step from the same numpy weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventad_tpu.config import Config as JaxConfig
from eventad_tpu.data.synthetic import make_synthetic_batch as jax_batch
from eventad_tpu.models import dagr as jdagr
from eventad_tpu.models.convert import export_backbone, export_eventad_head
from eventad_tpu.parallel import mesh as jmesh
from eventad_tpu.parallel import sharding as jsharding
from eventad_tpu.parallel import train_step as jts
from eventad_tpu_torch.models.convert import (export_detector_state,
                                              load_reference_state)
from eventad_tpu_torch.models.dagr import init_model
from eventad_tpu_torch.models.detector import init_detector
from eventad_tpu_torch.parallel.sharding import param_shardings
from eventad_tpu_torch.tools.dryrun_multichip import (detector_case,
                                                      fixture_config,
                                                      head_case)
from eventad_tpu_torch.utils.ema import ema_init, ema_update
from eventad_tpu_torch.utils.schedules import make_detector_optimizer

import _torch_threads  # noqa: F401  (one intra-op thread)
from _torch_dist import DETECTOR, HEAD, run

GLOBAL_BATCH = 2 * HEAD["batch_per_rank"]      # 2 data ranks
LOSS_RTOL = 1e-5        # the JAX test's bounds
LEAF_RTOL, LEAF_ATOL = 1e-4, 1e-6
STATS_TOL = 1e-5
EVAL_REL = 1e-4
JAX_TOL = 1e-4          # the port's 2-rank step against the JAX 2-device one
# the detector's gradients, of each leaf's scale: at least GRAD_FLOOR, as a
# bias that a batch-statistics BN follows has gradient 0 up to rounding,
# which the data group's sums in another order move by ~2e-9
GRAD_TOL = 1e-4
GRAD_FLOOR = 1e-4
LATER_LOSS_TOL = 1e-4   # the second step's loss, after a sign-like Adam step
# Each rank's updates are replayed in one process by the port's optimizer
# and EMA from the rank's own whole gradients: the parameters and the EMA
# after every step within REPLAY_TOL of the rate (a missing or misplaced
# update moves an element by up to the rate), the optimizer's moments
# within REPLAY_TOL of each leaf's scale.  The replay, not one process's
# run, is the reference for the updates: Adam divides each gradient by its
# own root mean square, so where a gradient is 0 up to rounding (a bias
# behind a batch-statistics BN) the two runs' updates differ by up to 0.3
# of the rate, and the second step's gradients follow
REPLAY_TOL = 1e-5
# the running statistics after two steps against one process, of each
# buffer's scale: the second forward runs on weights that differ where the
# first update followed rounding
STATS_AFTER_TOL = 3e-3


def _flat(tree, prefix=""):
    """``{path: array}`` of a tree of namespaces, dicts and sequences."""
    if tree is None:
        return {}
    if hasattr(tree, "__dict__") and not isinstance(tree, np.ndarray):
        tree = vars(tree)
    if isinstance(tree, dict):
        return {k: v for name, sub in tree.items()
                for k, v in _flat(sub, f"{prefix}.{name}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _flat(sub, f"{prefix}[{i}]").items()}
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    """The JAX package's sharded head step on 2 devices (dropout off), and
    the port's weights file made from the same JAX weights."""
    kw = dict(batch_size=GLOBAL_BATCH, width=96, height=72, scale=1,
              use_image=HEAD["use_image"],
              event_buckets=(HEAD["n_events"],),
              graph_lookback=HEAD["lookback"])
    jcfg = JaxConfig(**kw)
    static = {}

    def init(key):
        params, state, static["bc"], static["mc"] = jdagr.init_model(key,
                                                                     jcfg)
        return params, state
    params, state = jax.jit(init)(jax.random.PRNGKey(0))
    model, *_ = init_model(fixture_config(
        GLOBAL_BATCH, HEAD["n_events"], HEAD["use_image"], HEAD["lookback"]),
        device="cpu")
    load_reference_state(
        model, export_backbone(params.dagr.backbone, state.dagr.backbone),
        export_eventad_head(params.head))
    path = tmp_path_factory.mktemp("weights") / "model.pt"
    torch.save(model.state_dict(), path)

    opt = jts.make_optimizer(1e-3, 1e-5, 1.0)
    fns = jts.make_train_fns(jcfg, static["bc"],
                             static["mc"]._replace(dropout=0.0),
                             jdagr.graph_static_config(jcfg), opt)
    mesh = jmesh.make_mesh("2")
    batch = jax_batch(jcfg, seed=3)._replace(
        pool_tables=None, search_starts=None, image_s2d=None)
    rep = jmesh.replicated(mesh)

    def put(tree):   # copies: the step donates its inputs
        return jax.device_put(jax.tree.map(jnp.copy, tree), rep)
    p, _s, _o, m = fns.train_step(
        put(params), put(state), put(opt.init(params.head)),
        jmesh.shard_batch(jax.tree.map(jnp.asarray, batch), mesh),
        jax.random.PRNGKey(1))
    head = init_model(fixture_config(GLOBAL_BATCH, HEAD["n_events"]),
                      device="cpu")[0]
    load_reference_state(head, export_backbone(params.dagr.backbone,
                                               state.dagr.backbone),
                         export_eventad_head(p.head))
    return str(path), float(m["loss"]), {
        k: v.detach() for k, v in head.head.named_parameters()}


@pytest.fixture(scope="module")
def ranks(jax_step):
    return run("mesh_and_steps", 4, weights=jax_step[0])


@pytest.fixture(scope="module")
def single():
    """The head's and the detector's cases in one process, on the whole
    batch."""
    head = dict(HEAD, batch_per_rank=GLOBAL_BATCH)
    det = dict(DETECTOR, batch_per_rank=2 * DETECTOR["batch_per_rank"])
    return dict(head=head_case(None, dropout=True, steps=1, **head),
                detector=detector_case(None, **det))


def test_mesh_shapes_and_degrade(ranks):
    r = ranks[0]
    assert r["shapes"] == {"2x2": (2, 2), "4": (4, 1), "1x4": (1, 4)}
    assert r["degraded"] == (4, 1) and r["degrade_warned"]
    assert r["partial_raises"]


@pytest.mark.parametrize("use_image,m", [(False, 2), (True, 2), (True, 4)])
def test_model_axis_spec_matches_jax_layout(use_image, m):
    """Every detector parameter is split over the model axis along the
    dimension the JAX rule picks on its counterpart in the reference
    layout: this rank's slice of the port's tensor holds the elements of
    the JAX leaf's slice."""
    det, _ = init_detector(fixture_config(2, 512, use_image, 128),
                           device="cpu")
    params = list(det.parameters())
    dims = param_shardings(det, m)

    def export(fill):
        with torch.no_grad():
            for k, p in enumerate(params):
                p.copy_(fill(k, p))
        return _flat(export_detector_state(det)[0])
    owner = export(lambda k, p: torch.full_like(p, k))
    values = export(lambda k, p: torch.arange(
        p.numel(), dtype=torch.float32).reshape(p.shape))
    assert {int(a.flat[0]) for a in owner.values()} == set(range(
        len(params)))
    n_sharded = 0
    for path, leaf in values.items():
        k = int(owner[path].flat[0])
        spec = tuple(jsharding.model_axis_spec(leaf.shape, m))
        j = spec.index("model") if "model" in spec else None
        assert (j is None) == (dims[k] is None), (path, spec, dims[k])
        if j is None:
            continue
        n_sharded += 1
        p = params[k].detach()
        t = dims[k]
        mine = p.narrow(t, 0, p.shape[t] // m).reshape(-1).numpy()
        want = np.take(leaf, range(leaf.shape[j] // m), axis=j).reshape(-1)
        np.testing.assert_array_equal(np.sort(mine), np.sort(want), path)
    assert n_sharded >= 10


def test_dp_head_step_matches_single_process(ranks, single):
    """The 2-rank head step with dropout on equals one process's step on
    the whole batch: the loss, every head leaf and the running
    statistics."""
    one = single["head"]
    for r in ranks:
        got = r["head"]
        np.testing.assert_allclose(got["losses"], one["losses"],
                                   rtol=LOSS_RTOL)
        assert got["n_valid"] == one["n_valid"]
        for k, v in one["head"].items():
            np.testing.assert_allclose(got["head"][k], v, rtol=LEAF_RTOL,
                                       atol=LEAF_ATOL, err_msg=k)
        for k, v in one["buffers"].items():
            np.testing.assert_allclose(got["buffers"][k], v, rtol=STATS_TOL,
                                       atol=STATS_TOL, err_msg=k)


def test_dp_eval_matches_single_process(ranks, single):
    lg1, v1, lb1 = single["head"]["eval"]
    for r in ranks:
        lg, v, lb = r["head"]["eval"]
        assert torch.equal(v, v1) and torch.equal(lb, lb1)
        rel = float((lg - lg1).abs().max() / (lg1.abs().max() + 1e-6))
        assert rel < EVAL_REL, rel


def _replay(case):
    """The parameters and EMA after each step, and the optimizer state
    after the last, of the port's single-process optimizer and EMA applied
    to ``case``'s whole gradients from its initial parameters."""
    cfg = fixture_config(2, DETECTOR["n_events"])
    params = [p.clone().requires_grad_() for p in case["params"][0]]
    opt = make_detector_optimizer(params, cfg.optimizer,
                                  lambda step: DETECTOR["lr"],
                                  cfg.weight_decay, cfg.clip)
    ema = ema_init(params)
    steps = []
    for grads in case["grads"]:
        for p, g in zip(params, grads):
            p.grad = g.clone()
        opt.step()
        ema = ema_update(ema, params)
        steps.append(([p.detach().clone() for p in params],
                      [e.clone() for e in ema.params]))
    return steps, opt.state_dict()


def test_2x2_detector_step_matches_replicated(ranks, single):
    """Two dp x tp detector steps on the 2x2 mesh against one process: the
    losses, the first step's whole gradients, the running statistics after
    the steps; each rank's parameters, EMA and optimizer moments after
    each step against a replay of its updates; the same on every rank."""
    one = single["detector"]
    for case in [one] + [r["detector"] for r in ranks]:
        replayed, opt_state = _replay(case)
        for k, (ps, es) in enumerate(replayed):
            for i, (a, b) in enumerate(zip(case["params"][k + 1], ps)):
                assert float((a - b).abs().max()) \
                    <= REPLAY_TOL * DETECTOR["lr"], ("params", k, i)
            for i, (a, b) in enumerate(zip(case["ema"][k], es)):
                assert float((a - b).abs().max()) \
                    <= REPLAY_TOL * DETECTOR["lr"], ("ema", k, i)
        # the optimizer state gathered whole: an optimizer's over the
        # detector's parameters
        got = case["optimizer"]["state"]
        assert got.keys() == opt_state["state"].keys()
        for i, st in opt_state["state"].items():
            assert got[i].keys() == st.keys(), i
            for key, v in st.items():
                a = got[i][key]
                assert a.shape == v.shape, (i, key)
                assert float((a - v).abs().max()) \
                    <= REPLAY_TOL * float(v.abs().max()), (i, key)
    for r in ranks:
        got = r["detector"]
        assert got["n_sharded"] >= 10
        for k in one["losses"][0]:
            np.testing.assert_allclose(got["losses"][0][k],
                                       one["losses"][0][k], rtol=LOSS_RTOL,
                                       err_msg=k)
        np.testing.assert_allclose(got["losses"][1]["total"],
                                   one["losses"][1]["total"],
                                   rtol=LATER_LOSS_TOL)
        for i, (a, b) in enumerate(zip(got["grads"][0], one["grads"][0])):
            scale = max(float(b.abs().max()), GRAD_FLOOR)
            assert float((a - b).abs().max()) <= GRAD_TOL * scale, i
        for a, b in zip(got["params"][0], one["params"][0]):
            assert torch.equal(a, b)
        for k, v in one["buffers"].items():
            assert float((got["buffers"][k] - v).abs().max()) \
                <= STATS_AFTER_TOL * float(v.abs().max()), k
    for r in ranks[1:]:
        for k, v in ranks[0]["detector"]["state"].items():
            assert torch.equal(r["detector"]["state"][k], v), k


def test_dp_head_step_matches_jax_sharded_step(ranks, jax_step):
    """The port's 2-rank head step (dropout off) from the JAX weights
    against the JAX package's 2-device sharded step."""
    _, jax_loss, jax_head = jax_step
    got = ranks[0]["head_from_jax"]
    np.testing.assert_allclose(got["losses"][0], jax_loss, rtol=JAX_TOL)
    for k, v in jax_head.items():
        np.testing.assert_allclose(got["head"][k], v, rtol=JAX_TOL,
                                   atol=JAX_TOL * float(v.abs().max()),
                                   err_msg=k)
