"""The batched scoring forward as a whole: JAX ``init_model`` -> reference
-format export -> the port's ``load_reference_state``, then ``model_forward``
on the same batch in both packages (ResNet-50 image branch, fixture
geometry), in f32 and in bf16; plus the pooling and the CNN branch on their
own."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventad_tpu.config import Config as JaxConfig
from eventad_tpu.data.synthetic import make_synthetic_batch as jax_batch
from eventad_tpu.models import dagr as jdagr
from eventad_tpu.models.convert import (export_backbone, export_cnn_branch,
                                        export_eventad_head)
from eventad_tpu.models.resnet import cnn_branch_forward as jax_cnn
from eventad_tpu.ops.pooling import pool_graph as jax_pool
from eventad_tpu_torch.config import Config
from eventad_tpu_torch.data.synthetic import make_synthetic_batch
from eventad_tpu_torch.models.convert import load_reference_state
from eventad_tpu_torch.models.dagr import (graph_static_config, init_model,
                                           model_forward)
from eventad_tpu_torch.models.resnet import cnn_branch_forward
from eventad_tpu_torch.ops.pooling import pool_graph

KW = dict(batch_size=2, use_image=True, width=96, height=72, scale=1,
          event_buckets=(4096,), graph_lookback=512)
F32_TOL = 1e-4     # logits, f32 both sides (full-precision matmuls)
BF16_TOL = 0.05    # logits, bf16 features (tests/test_bf16_path.py band)


@pytest.fixture(scope="module")
def pair():
    """Both models with the same weights (JAX init, exported through the
    reference checkpoint layout) and the same batch."""
    jcfg = JaxConfig(**KW)
    params, state, bc, mc = jdagr.init_model(jax.random.PRNGKey(0), jcfg)
    sd = export_backbone(params.dagr.backbone, state.dagr.backbone)
    sd.update(export_cnn_branch(params.dagr.cnn, state.dagr.cnn))
    cfg = Config(**KW)
    model, tbc, tmc = init_model(cfg, torch.Generator().manual_seed(1),
                                    device="cpu")
    load_reference_state(model, sd, export_eventad_head(params.head))
    jb = jax_batch(jcfg, seed=3)._replace(pool_tables=None,
                                          search_starts=None, image_s2d=None)
    return dict(jax=(params, state, bc, mc, jax.tree.map(jnp.asarray, jb),
                     jdagr.graph_static_config(jcfg)),
                torch=(model, tbc, tmc, make_synthetic_batch(cfg, seed=3),
                       graph_static_config(cfg)))


def _run(pair, dtype):
    params, state, bc, mc, jb, jgsc = pair["jax"]
    model, tbc, tmc, tb, gsc = pair["torch"]
    jbc = bc._replace(compute_dtype=dtype)
    want, _ = jax.jit(lambda p, s, b: jdagr.model_forward(
        p, s, b, jbc, mc, jgsc))(params, state, jb)
    got = model_forward(model, tb, tbc._replace(compute_dtype=dtype), tmc,
                        gsc)
    return want, got


@pytest.mark.parametrize("dtype,tol", [("float32", F32_TOL),
                                       ("bfloat16", BF16_TOL)])
def test_model_forward_matches_jax(pair, dtype, tol):
    want, got = _run(pair, dtype)
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    assert valid.sum() >= 4
    assert got.logits.shape == (2, 31, 2)
    assert torch.isfinite(got.logits).all()
    d = np.abs(got.logits.numpy()[valid] - np.asarray(want.logits)[valid])
    assert d.max() < tol, d.max()
    assert abs(float(got.loss) - float(want.loss)) \
        < tol * max(1.0, valid.sum())
    assert int(got.n_valid) == int(want.n_valid)


@pytest.mark.parametrize("aggr,with_pos_src", [("max", True),
                                               ("mean", False)])
def test_pool_graph_matches(rng, aggr, with_pos_src):
    n, k, grid = 3000, 6, (12, 9)
    pos = np.concatenate([rng.randint(0, 96, (n, 1)) / np.float32(96),
                          rng.randint(0, 72, (n, 1)) / np.float32(72),
                          rng.rand(n, 1)], 1).astype(np.float32)
    batch = np.repeat(np.arange(2), n // 2).astype(np.int32)
    nbr = np.clip(np.arange(n)[:, None] - rng.randint(0, 40, (n, k)), 0,
                  n - 1).astype(np.int32)
    nbr_mask = rng.rand(n, k) > 0.3
    node_mask = rng.rand(n) > 0.1
    x = rng.randn(n, 8).astype(np.float32)
    pos_src = pos[nbr][..., :2] if with_pos_src else None
    kw = dict(grid=grid, batch_size=2, width=96, height=72, aggr=aggr,
              return_pos_nbr=True)
    jg, jpn = jax_pool(*map(jnp.asarray, (x, pos, nbr, nbr_mask, node_mask,
                                          batch)),
                       pos_src=None if pos_src is None
                       else jnp.asarray(pos_src), **kw)
    tg, tpn = pool_graph(*map(torch.from_numpy, (x, pos, nbr, nbr_mask,
                                                 node_mask, batch)),
                         pos_src=None if pos_src is None
                         else torch.from_numpy(pos_src), **kw)
    for name in ("x", "pos", "nbr", "nbr_mask", "node_mask", "batch"):
        np.testing.assert_allclose(getattr(tg, name).numpy(),
                                   np.asarray(getattr(jg, name)),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
    np.testing.assert_array_equal(tpn.numpy(), np.asarray(jpn))
    assert tg.nbr_mask.sum() > 100


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 5e-2)])
def test_cnn_branch_matches(pair, dtype, tol):
    params, state, bc, mc, jb, _ = pair["jax"]
    model = pair["torch"][0]
    image = pair["torch"][3].image
    want, _, _ = jax_cnn(params.dagr.cnn, state.dagr.cnn, jb.image,
                         "resnet50", compute_dtype=dtype)
    with torch.no_grad():
        got = cnn_branch_forward(model.dagr.cnn, image, dtype)
    assert len(got) == 5
    for g, w in zip(got, want):
        w = np.asarray(w, np.float32)
        assert g.shape == w.shape
        rel = np.abs(g.float().numpy() - w).max() / np.abs(w).max()
        assert rel < tol, rel
