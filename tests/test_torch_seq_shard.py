"""Event-axis sequence parallelism of the port (``parallel/seq_shard.py``)
equals the single-process streaming ``refresh`` on the same stream (the
counterpart of ``tests/test_seq_shard.py``): 2 gloo ranks, each block at
least twice the lookback, with the image branch."""
import types

import numpy as np
import pytest
import torch

from eventad_tpu_torch.models.dagr import graph_static_config, init_model
from eventad_tpu_torch.parallel.seq_shard import (check_blocks,
                                                  seq_sharded_features)
from eventad_tpu_torch.streaming import incremental as inc
from eventad_tpu_torch.tools.dryrun_multichip import fixture_config, stream

import _torch_threads  # noqa: F401  (one intra-op thread)
from _torch_dist import run

N, LOOKBACK, SEED = 2048, 256, 1
REL = 1e-5   # the JAX test's bound


def _refresh_outs():
    """The single-process truth: ``refresh`` + ``pooled_backbone_outs`` of
    ``seq_case``'s stream, model and image."""
    cfg = fixture_config(1, N, True, LOOKBACK)
    model, bc, mc = init_model(cfg, torch.Generator().manual_seed(SEED),
                               "cpu")
    gsc = graph_static_config(cfg)
    pos, pol = stream(N, cfg.model_width, cfg.model_height, SEED)
    rng = np.random.RandomState(SEED + 1)
    img = torch.from_numpy(rng.rand(cfg.model_height, cfg.model_width,
                                    3).astype(np.float32))
    st = inc.update_image(model, inc.init_incremental_state(
        N, bc, mc, cfg.max_neighbors, "cpu"), img)
    st = inc.insert_raw(st, pos, pol, N)
    refresh, _ = inc.make_incremental_step(model, bc, mc, gsc, n_chunk=256,
                                           n_buf=N)
    st = refresh(st)
    return inc.pooled_backbone_outs(model, bc, st,
                                    inc.norm_pos(st.pos, st.t_now, gsc),
                                    gsc)


def test_seq_sharded_features_match_single_process():
    ranks = run("seq_case_world", 2, n=N, lookback=LOOKBACK, use_image=True,
                seed=SEED)
    ref = _refresh_outs()
    for r in ranks:
        for lvl, ((x, mask), g) in enumerate(zip(r, ref)):
            assert torch.equal(mask, g.node_mask), lvl
            xr = torch.where(g.node_mask[:, None], g.x, 0.0)
            xs = torch.where(mask[:, None], x, 0.0)
            rel = float((xr - xs).abs().max() / (xr.abs().max() + 1e-6))
            assert rel < REL, (lvl, rel)


@pytest.mark.parametrize("n,d,lookback", [(1000, 3, 64), (1024, 4, 200)])
def test_guard_raises_before_any_collective(n, d, lookback):
    """An uneven split or a block under twice the lookback raises
    ``ValueError`` in this process: no process group exists here, so a
    collective reached first would fail otherwise."""
    with pytest.raises(ValueError):
        check_blocks(n, d, lookback)
    cfg = fixture_config(1, n, False, lookback)
    model, bc, _ = init_model(cfg, device="cpu")
    mesh = {"data": types.SimpleNamespace(size=lambda: d)}
    pos, pol = stream(n, cfg.model_width, cfg.model_height)
    with pytest.raises(ValueError, match="seq shard"):
        seq_sharded_features(model, bc, graph_static_config(cfg), pos, pol,
                             torch.ones(n, dtype=torch.bool), None, mesh)
