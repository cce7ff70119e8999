"""``--mesh`` on the port's entry modules: started as one process the
evaluation says that it runs on one process and gives its metrics; under
``torchrun --nproc_per_node 2`` the same command evaluates data parallel
and gives the same metrics (on the generated on-disk fixture, FPS off so
that mRESPONSE reads the fixed rate)."""
import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from eventad_tpu_torch.config import parse_args
from eventad_tpu_torch.data.batching import Loader
from eventad_tpu_torch.data.dataset import SequenceDataset
from eventad_tpu_torch.models.dagr import init_model
from eventad_tpu_torch.test import main as evaluate_main
from eventad_tpu_torch.train import prepare_dataset
from eventad_tpu_torch.utils.checkpoint import save_model

import _torch_threads  # noqa: F401  (one intra-op thread)

ROOT = Path(__file__).resolve().parent.parent
METRIC_TOL = 1e-6

_RUNNER = """
import json, os, sys
from eventad_tpu_torch.test import main
out = main(sys.argv[2:])
if os.environ["RANK"] == "0":
    keys = (("bbox", "auc"), ("bbox", "ap"), ("frame", "auc_frame"),
            ("tta", "mtta"), ("response", "mresponse"))
    with open(sys.argv[1], "w") as f:
        json.dump({f"{a}.{b}": float(out[a][b]) for a, b in keys}, f)
"""


def _args(tmp: Path):
    return ["--device", "cpu", "--synthetic_data", "true",
            "--dataset_directory", str(tmp / "synth"), "--width", "96",
            "--height", "72", "--scale", "1", "--batch_size", "2",
            "--use_image", "false", "--event_buckets", "4096",
            "--graph_lookback", "512", "--num_workers", "0",
            "--measure_fps", "false", "--output_dir", str(tmp / "out"),
            "--test_checkpoint", str(tmp / "head.pt"), "--mesh", "2"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The fixture's head with the anomaly logit lifted by 5 (so that the
    scores cross mTTA's thresholds before the anomalies), evaluated in one
    process."""
    tmp = tmp_path_factory.mktemp("mesh_entry")
    model, _, _ = init_model(parse_args(_args(tmp)), device="cpu")
    with torch.no_grad():
        model.head.fusion.fuse2_b[1] += 5.0
    save_model(tmp / "head.pt", model)
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        one = evaluate_main(_args(tmp))
    assert np.isfinite([one["tta"]["mtta"], one["response"]["mresponse"]]
                       ).all()
    return tmp, one, printed.getvalue()


def test_mesh_in_one_process_says_so(runs):
    out = runs[2]
    assert "mesh 2: this run has one process" in out
    assert "running on one process" in out
    assert "==== Main Metrics Summary ====" in out


def test_torchrun_two_processes_give_the_single_process_metrics(runs):
    tmp, one, _ = runs
    script = tmp / "runner.py"
    script.write_text(_RUNNER)
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", str(script), str(tmp / "m.json")]
        + _args(tmp), cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert res.returncode == 0, res.stderr[-3000:]
    assert "mesh: data 2 x model 1 over 2 processes (gloo)" in res.stdout
    got = json.loads((tmp / "m.json").read_text())
    for fam, key in (("bbox", "auc"), ("bbox", "ap"),
                     ("frame", "auc_frame")):
        assert abs(got[f"{fam}.{key}"] - one[fam][key]) <= METRIC_TOL, key
    assert got["tta.mtta"] == one["tta"]["mtta"]
    assert got["response.mresponse"] == one["response"]["mresponse"]


def test_loader_rank_blocks_are_the_single_process_batches(runs):
    """Rank r of 2 loads the r-th half of every shuffled batch: the ranks'
    batches, joined in rank order, are the single-process batches."""
    tmp = runs[0]
    cfg = prepare_dataset(parse_args(_args(tmp))).replace(batch_size=4)
    ds = SequenceDataset(cfg, tmp / "synth", "val")
    kw = dict(shuffle=True, seed=3, num_workers=0, prefetch=0)
    whole = list(Loader(ds, cfg, **kw))
    parts = [list(Loader(ds, cfg, rank=r, world=2, **kw)) for r in (0, 1)]
    assert len(whole) == len(parts[0]) == len(parts[1]) > 1
    for (batch, meta), (b0, m0), (b1, m1) in zip(whole, *parts):
        for k, (a, x, y) in enumerate(zip(batch, b0, b1)):
            assert torch.equal(a, torch.cat([x, y])), k
        assert meta.sequences == m0.sequences + m1.sequences
        assert meta.frame_ids == m0.frame_ids + m1.frame_ids
        assert meta.n_items == m0.n_items + m1.n_items
