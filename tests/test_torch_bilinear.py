"""K7, the bilinear sampler: the port's plain version against the JAX
package's Pallas kernel ``sample_bilinear_mxu`` in interpret mode and
against its oracle ``sample_image_features``, on the cases of
``tests/test_bilinear_sample.py`` and on an N and a C that the TPU kernel
refuses; at the pooled levels' shapes against ``sample_image_features``,
the lookup it replaces there on the card, and wired into
``backbone_forward`` on that route.  The CUDA kernel is held against this
plain version on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eventad_tpu.models.graph import sample_image_features
from eventad_tpu.ops.bilinear_sample import sample_bilinear_mxu
from eventad_tpu_torch.models.graph import \
    sample_image_features as torch_sample_image_features
from eventad_tpu_torch.ops.bilinear_sample import (sample_bilinear,
                                                   sample_bilinear_cuda,
                                                   sample_bilinear_plain)

import _torch_threads  # noqa: F401  (one intra-op thread)

W, H = 360, 240
F32_TOL = 1e-4     # rtol and atol, tests/test_bilinear_sample.py
BF16_TOL = 0.05    # its bf16 band: the weights or the blend round in bf16

# name: (items, rows per item, hp, wp, C, fractional positions, bf16)
CASES = {
    "coarse": (2, 256, 30, 45, 64, False, False),
    "fine": (2, 128, 120, 180, 16, False, False),
    "out_of_range": (1, 128, 30, 45, 64, True, False),
    "bf16": (2, 128, 30, 45, 64, False, True),
}


def _inputs(b, n_max, hp, wp, c, frac_pos, seed=0):
    rng = np.random.RandomState(seed)
    feat = rng.randn(b, hp, wp, c).astype(np.float32)
    n = b * n_max
    if frac_pos:     # arbitrary fractions, some outside the map
        px, py = rng.rand(n) * 1.1 - 0.05, rng.rand(n) * 1.1 - 0.05
    else:
        px, py = rng.randint(0, W, n) / W, rng.randint(0, H, n) / H
    pos = np.stack([px, py, np.zeros(n)], 1).astype(np.float32)
    mask = rng.rand(n) > 0.15
    batch = np.repeat(np.arange(b, dtype=np.int32), n_max)
    return feat, pos, mask, batch


@pytest.mark.parametrize("name", list(CASES))
def test_plain_matches_pallas_interpret_and_oracle(name):
    b, n_max, hp, wp, c, frac_pos, bf16 = CASES[name]
    feat, pos, mask, batch = _inputs(b, n_max, hp, wp, c, frac_pos)
    jfeat = jnp.asarray(feat)
    tfeat = torch.from_numpy(feat)
    if bf16:
        jfeat, tfeat = jfeat.astype(jnp.bfloat16), tfeat.bfloat16()
    got = sample_bilinear_plain(tfeat, torch.from_numpy(pos),
                                torch.from_numpy(mask), full_width=W,
                                full_height=H,
                                batch=torch.from_numpy(batch))
    assert got.dtype == tfeat.dtype and got.shape == (b * n_max, c)
    assert (got[~torch.from_numpy(mask)] == 0).all()
    # without ``batch`` the item is the row's block
    blocks = sample_bilinear(tfeat, torch.from_numpy(pos),
                             torch.from_numpy(mask), full_width=W,
                             full_height=H)
    assert torch.equal(got, blocks)
    got = got.float().numpy()
    tol = BF16_TOL if bf16 else F32_TOL
    kernel = sample_bilinear_mxu(jfeat, jnp.asarray(pos), jnp.asarray(mask),
                                 full_width=W, full_height=H, batch_size=b,
                                 interpret=True)
    oracle = sample_image_features(jfeat, jnp.asarray(pos),
                                   jnp.asarray(batch), jnp.asarray(mask),
                                   W, H)
    for want in (kernel, oracle):
        np.testing.assert_allclose(
            got, np.asarray(want.astype(jnp.float32)), rtol=tol, atol=tol)


def test_any_row_count_and_width_against_the_port_oracle():
    """N = 3 x 77 rows and C = 5: the TPU kernel takes neither (rows per
    item a multiple of 128, C a multiple of 8); the port's sampler does."""
    b, n_max, hp, wp, c = 3, 77, 9, 13, 5
    feat, pos, mask, batch = _inputs(b, n_max, hp, wp, c, True, seed=1)
    with pytest.raises(AssertionError):
        sample_bilinear_mxu(jnp.asarray(feat), jnp.asarray(pos),
                            jnp.asarray(mask), full_width=W, full_height=H,
                            batch_size=b, interpret=True)
    # items out of order, which only ``batch`` can say
    order = np.random.RandomState(2).permutation(b * n_max)
    pos, mask, batch = pos[order], mask[order], batch[order]
    args = (torch.from_numpy(feat), torch.from_numpy(pos))
    got = sample_bilinear_plain(*args, torch.from_numpy(mask), full_width=W,
                                full_height=H, batch=torch.from_numpy(batch))
    want = torch_sample_image_features(
        *args, torch.from_numpy(batch), torch.from_numpy(mask), W, H)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)
    oracle = sample_image_features(
        jnp.asarray(feat), jnp.asarray(pos), jnp.asarray(batch),
        jnp.asarray(mask), W, H)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=F32_TOL,
                               atol=F32_TOL)
    with pytest.raises(ValueError, match="do not split"):
        sample_bilinear_plain(torch.from_numpy(feat),
                              torch.from_numpy(pos[:100]),
                              torch.from_numpy(mask[:100]), full_width=W,
                              full_height=H)


def test_cuda_wrapper_refuses_cpu_tensors():
    feat, pos, mask, batch = _inputs(1, 128, 30, 45, 64, False)
    before = sample_bilinear_cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        sample_bilinear_cuda(torch.from_numpy(feat), torch.from_numpy(pos),
                             torch.from_numpy(mask), full_width=W,
                             full_height=H, batch=torch.from_numpy(batch))
    assert sample_bilinear_cuda.launches == before


@pytest.mark.parametrize("bf16", [False, True])
def test_out_view_receives_the_column_range_and_nothing_else(bf16):
    """``out=`` a column range of a wider table: the range equals the call
    without ``out`` (and the Pallas kernel in interpret mode), every other
    value of the table keeps its sentinel."""
    b, n_max, hp, wp, c = 2, 128, 30, 45, 64
    feat, pos, mask, batch = _inputs(b, n_max, hp, wp, c, False, seed=3)
    jfeat, tfeat = jnp.asarray(feat), torch.from_numpy(feat)
    if bf16:
        jfeat, tfeat = jfeat.astype(jnp.bfloat16), tfeat.bfloat16()
    args = (tfeat, torch.from_numpy(pos), torch.from_numpy(mask))
    kw = dict(full_width=W, full_height=H, batch=torch.from_numpy(batch))
    want = sample_bilinear(*args, **kw)
    table = torch.full((b * n_max, c + 24), 7.0, dtype=tfeat.dtype)
    got = sample_bilinear(*args, out=table[:, 16:16 + c], **kw)
    assert got.data_ptr() == table[:, 16:].data_ptr()
    assert torch.equal(table[:, 16:16 + c], want)
    assert (table[:, :16] == 7).all() and (table[:, 16 + c:] == 7).all()
    kernel = sample_bilinear_mxu(jfeat, jnp.asarray(pos), jnp.asarray(mask),
                                 full_width=W, full_height=H, batch_size=b,
                                 interpret=True)
    tol = BF16_TOL if bf16 else F32_TOL
    np.testing.assert_allclose(
        table[:, 16:16 + c].float().numpy(),
        np.asarray(kernel.astype(jnp.float32)), rtol=tol, atol=tol)


@pytest.mark.parametrize("fault,match", [
    ("dtype", "out: expected"), ("shape", "out: expected shape"),
    ("stride", "unit channel stride")])
def test_out_is_checked(fault, match):
    feat, pos, mask, batch = _inputs(1, 128, 30, 45, 64, False)
    n, c = 128, 64
    out = {"dtype": torch.empty(n, c, dtype=torch.bfloat16),
           "shape": torch.empty(n, c + 1),
           "stride": torch.empty(c, n).t()}[fault]
    with pytest.raises(ValueError, match=match):
        sample_bilinear(torch.from_numpy(feat), torch.from_numpy(pos),
                        torch.from_numpy(mask), full_width=W, full_height=H,
                        out=out)


def test_cuda_wrapper_takes_the_bool_mask_as_it_is():
    """The kernel reads the mask's own bytes: a ``bool`` (or ``uint8``) mask
    passes the wrapper's checks uncast, any other type is refused."""
    feat, pos, mask, batch = _inputs(1, 128, 30, 45, 64, False)
    args = (torch.from_numpy(feat), torch.from_numpy(pos))
    with pytest.raises(ValueError, match="bool or uint8"):
        sample_bilinear_cuda(*args, torch.from_numpy(mask).float(),
                             full_width=W, full_height=H)
    assert torch.from_numpy(mask).element_size() == 1
    with pytest.raises(ValueError, match="CUDA"):     # past the mask check
        sample_bilinear_cuda(*args, torch.from_numpy(mask), full_width=W,
                             full_height=H)


# the pooled levels' lookup at the operating point (360x240, ResNet-50):
# level: (rows, hp, wp, C), the rows of a stream read's pooled grid (56 x
# 40, 28 x 20, 14 x 10 cells), here split into two items, and the map of
# the ResNet stage the level reads
POOLED_LEVELS = {2: (2240, 30, 45, 64), 3: (560, 15, 23, 64),
                 4: (140, 8, 12, 64)}


@pytest.mark.parametrize("level", sorted(POOLED_LEVELS))
def test_k7_at_the_pooled_levels_against_sample_image_features(level):
    """What K7 computes at levels 2-4 on the bf16 route against
    ``sample_image_features``, the lookup it replaces there: two items
    through ``batch``, positions on the pixel grid as the pooling rounds
    them, the four corners (0 and 1: taps off the map) among them, masked
    rows.  Against the f32 evaluation of the same bf16 map it lies within
    one bf16 step of scale (it blends in f32 and rounds once); against the
    bf16 evaluation, which rounds each product, within two, and never
    farther from the f32 evaluation than that one is."""
    n, hp, wp, c = POOLED_LEVELS[level]
    gen = torch.Generator().manual_seed(level)
    feat = torch.randn((2, hp, wp, c), generator=gen).bfloat16()
    px = torch.randint(0, W, (n,), generator=gen) / W
    py = torch.randint(0, H, (n,), generator=gen) / H
    px[:4], py[:4] = torch.tensor([0., 1., 0., 1.]), torch.tensor(
        [0., 1., 1., 0.])
    pos = torch.stack([px, py, torch.rand(n, generator=gen)], 1)
    batch = (torch.arange(n) >= n // 2).to(torch.int32)
    batch[1] = 1            # a corner of the second item among the first's
    mask = torch.rand(n, generator=gen) > 0.2
    mask[:4] = True
    got = sample_bilinear_plain(feat, pos, mask, full_width=W,
                                full_height=H, batch=batch)
    assert got.dtype == torch.bfloat16 and got.shape == (n, c)
    assert (got[~mask] == 0).all()
    want32 = torch_sample_image_features(feat.float(), pos, batch, mask, W,
                                         H)
    want16 = torch_sample_image_features(feat, pos, batch, mask, W, H)
    step = torch.finfo(torch.bfloat16).eps * want32.abs().max().item()
    err32 = (got.float() - want32).abs().max().item()
    err16 = (got.float() - want16.float()).abs().max().item()
    assert err32 <= step, (err32, step)
    assert err16 <= 2 * step, (err16, step)
    assert err32 <= (want16.float() - want32).abs().max().item()
    # a corner at 1 reads its last row or column and the zero beyond it
    assert got[1].float().abs().max() > 0


def test_backbone_pooled_image_route_on_the_cpu(monkeypatch):
    """The route's K7 lookup wired into ``backbone_forward``, forced on the
    CPU (where ``sample_bilinear`` runs its plain version): at levels 2-4
    the sampler writes the image columns of the level's input table, whose
    first columns are the previous layer's output bit for bit, and the
    outputs lie within the bf16 band of the default route's.  The streaming
    tests' 48x36 geometry, two items."""
    from eventad_tpu_torch.config import Config
    from eventad_tpu_torch.data.synthetic import make_synthetic_batch
    from eventad_tpu_torch.models import backbone as tbb
    from eventad_tpu_torch.models.dagr import (build_level0_graph,
                                               graph_static_config,
                                               init_model)
    from eventad_tpu_torch.models.resnet import cnn_branch_forward

    cfg = Config(batch_size=2, width=48, height=36, scale=1,
                 event_buckets=(512,), graph_lookback=512, use_image=True,
                 compute_dtype="bfloat16")
    model, bc, _ = init_model(cfg, torch.Generator().manual_seed(1),
                              device="cpu")
    b = make_synthetic_batch(cfg)
    with torch.no_grad():
        g0 = build_level0_graph(b.pos, b.polarity, b.valid,
                                graph_static_config(cfg), b.rank)
        feats = cnn_branch_forward(model.dagr.cnn, b.image, bc.compute_dtype)
        assert tbb.frozen_route(bc, torch.bfloat16, g0.x.device,
                                False).pooled_image == "plain"
        want = tbb.backbone_forward(model.dagr.backbone, g0, feats, bc)

        route, pool_in, layer_out, views = tbb.frozen_route, [], [], []
        pool, layer, sampler = tbb.pool_graph, tbb.apply_layer, \
            tbb.sample_bilinear
        monkeypatch.setattr(tbb, "frozen_route", lambda *a: route(*a)
                            ._replace(pooled_image="K7"))
        monkeypatch.setattr(tbb, "pool_graph", lambda x, *a, **kw: (
            pool_in.append(x), pool(x, *a, **kw))[1])
        monkeypatch.setattr(tbb, "apply_layer", lambda *a, **kw: (
            lambda out: (layer_out.append(out[0]), out)[1])(
                layer(*a, **kw)))
        monkeypatch.setattr(tbb, "sample_bilinear", lambda *a, **kw: (
            views.append(kw["out"]), sampler(*a, **kw))[1])
        got = tbb.backbone_forward(model.dagr.backbone, g0, feats, bc)

    assert len(views) == 3 and len(pool_in) == 4 and len(layer_out) == 5
    for level in (2, 3, 4):
        table, prev = pool_in[level - 1], layer_out[level - 1]
        cx = prev.x.shape[1]
        assert table.dtype == torch.bfloat16
        assert views[level - 2].data_ptr() == table[:, cx:].data_ptr()
        assert torch.equal(table[:, :cx], prev.x)
        assert torch.equal(table[:, cx:], sample_bilinear_plain(
            feats[level], prev.pos, prev.node_mask, full_width=bc.width,
            full_height=bc.height, batch=prev.batch))
        assert (table[~prev.node_mask, cx:] == 0).all()
    assert len(got) == len(want) == 2
    for tg, wg in zip(got, want):
        assert torch.equal(tg.node_mask, wg.node_mask)
        assert torch.equal(tg.nbr_mask, wg.nbr_mask)
        assert tg.node_mask.sum() > 0
        scale = wg.x.float().abs().max().item()
        err = (tg.x.float() - wg.x.float()).abs().max().item()
        assert 0 < scale and err <= BF16_TOL * scale, (err, scale)
