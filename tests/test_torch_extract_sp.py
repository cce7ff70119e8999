"""The port's sequence-parallel extraction tool (``python -m
eventad_tpu_torch.tools.extract_sp``) runs end to end on 2 gloo processes
and its ``--check`` holds the sharded features against the single-process
path; ``--checkpoint`` reads a ``train`` checkpoint of the port (the
counterpart of ``tests/test_extract_sp.py``)."""
import numpy as np
import torch

from eventad_tpu_torch.config import Config
from eventad_tpu_torch.models.dagr import init_model
from eventad_tpu_torch.tools import extract_sp
from eventad_tpu_torch.utils.checkpoint import save_model

import _torch_threads  # noqa: F401  (one intra-op thread)

GEOM = ["--width", "96", "--height", "72", "--scale", "1", "--device",
        "cpu"]


def test_extract_sp_tool_runs_and_checks(tmp_path, capsys):
    out = tmp_path / "sp_feats.npz"
    extract_sp.main(["--devices", "2", "--events", "4096",
                     "--graph_lookback", "256", "--check", "--out",
                     str(out)] + GEOM)
    assert "check OK" in capsys.readouterr().out
    data = np.load(out)
    assert data["out4_x"].shape[0] == 35          # 7x5 top-level cell table
    assert data["out4_mask"].any()
    assert np.isfinite(data["out4_x"]).all()


def test_extract_sp_tool_checkpoint_roundtrip(tmp_path, capsys):
    """A ``train`` checkpoint's weights reach the extraction: the features
    differ from the seed-0 weights' and still pass ``--check``."""
    cfg = Config(batch_size=1, width=96, height=72, scale=1,
                 use_image=False, event_buckets=(2048,), graph_lookback=256)
    model, _, _ = init_model(cfg, torch.Generator().manual_seed(7), "cpu")
    ck = tmp_path / "latest_checkpoint.pt"
    save_model(ck, model)
    args = ["--devices", "2", "--events", "2048", "--graph_lookback", "256",
            "--use_image", "false", "--check"] + GEOM
    outs = []
    for extra in ([], ["--checkpoint", str(ck)]):
        out = tmp_path / f"feats{len(extra)}.npz"
        extract_sp.main(args + extra + ["--out", str(out)])
        outs.append(np.load(out)["out4_x"])
    printed = capsys.readouterr().out
    assert f"loaded weights from {ck}" in printed
    assert printed.count("check OK") == 2
    assert not np.allclose(outs[0], outs[1])
