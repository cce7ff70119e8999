"""The PyTorch port imports no JAX-side module, runs on the card unless the
caller names the CPU, and its configuration and synthetic batches equal the
JAX package's."""
import ast
import dataclasses
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from eventad_tpu.config import Config as JaxConfig
from eventad_tpu.data.synthetic import make_synthetic_batch as jax_batch
from eventad_tpu.models.backbone import make_backbone_config as jax_bc
from eventad_tpu_torch.config import Config
from eventad_tpu_torch.data.batching import queue_ranks
from eventad_tpu_torch.data.synthetic import make_synthetic_batch
from eventad_tpu_torch.models.backbone import make_backbone_config
from eventad_tpu_torch.models.dagr import init_model, resolve_device
from eventad_tpu_torch.parallel.train_step import (make_optimizer,
                                                   make_train_fns)
from eventad_tpu_torch.bench_detector import main as bench_detector_main
from eventad_tpu_torch.models.detector import init_detector
from eventad_tpu_torch.parity import main as parity_main
from eventad_tpu_torch.test import main as evaluate_main
from eventad_tpu_torch.test_detector import main as detector_eval_main
from eventad_tpu_torch.tools.check_fused import main as check_fused_main
from eventad_tpu_torch.train import main as train_main
from eventad_tpu_torch.train_detector import main as train_detector_main

import _torch_threads  # noqa: F401  (one intra-op thread)

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import eventad_tpu_torch
pkg = eventad_tpu_torch
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n.split('.')[0] in ('jax', 'jaxlib', 'yaml', 'ml_dtypes',
                                    'eventad_tpu', 'triton', 'optax',
                                    'sklearn', 'h5py', 'cv2', 'matplotlib',
                                    'wandb'))
print('MODULES', sum(n.startswith(pkg.__name__) for n in sys.modules))
print('BAD', bad)
print('HAS', sorted(n for n in sys.modules if n.startswith(pkg.__name__)))
"""


def test_port_imports_no_jax_yaml_or_reference_package():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    n_mods = int(res.stdout.split("MODULES")[1].split()[0])
    # the training, detection and kernel-flavour modules included
    assert n_mods >= 40, res.stdout
    # detector training's modules among them, and the data layer's
    for name in ("train_detector", "models.yolox_loss", "utils.ema",
                 "utils.schedules", "native", "data.h5io", "data.tracks",
                 "data.dataset", "data.augment", "data.fixtures",
                 "data.batching", "utils.result", "utils.logging",
                 "utils.visualization", "utils.viz", "parity"):
        assert f"'eventad_tpu_torch.{name}'" in res.stdout, name


def test_entry_points_default_to_the_card():
    """Without a CUDA device nothing falls back to the CPU silently."""
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    cfg = Config(batch_size=1, use_image=False, width=96, height=72, scale=1,
                 event_buckets=(256,))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_model(cfg)
    model, bc, mc = init_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_train_fns(model, bc, mc, (), make_optimizer(
            model.head.parameters(), 1e-3, 1e-5, 1.0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        init_detector(cfg)
    for main in (train_main, evaluate_main, detector_eval_main,
                 train_detector_main, parity_main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--batch_size", "1"])
    for main in (bench_detector_main, check_fused_main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["256"])


def test_check_fused_flavours_on_the_cpu(capsys):
    """The flavour check end to end at a small geometry: every bf16 flavour
    (the generic ones through K5's and K7's plain versions) inside the band
    around the f32 run."""
    from eventad_tpu_torch.tools.check_fused import FLAVOURS, flavour_errors
    cfg = Config(batch_size=2, use_image=True, width=96, height=72, scale=1,
                 event_buckets=(1024,), graph_lookback=256,
                 compute_dtype="bfloat16")
    rel = flavour_errors(cfg, torch.device("cpu"))
    assert set(rel) == set(FLAVOURS) == {"base", "two_block", "shift",
                                         "default", "bilinear"}
    band = max(1.5 * rel["base"], 2e-2)
    assert all(0 < r <= band for r in rel.values()), rel
    # on the CPU the default flags route as before: the flavours that differ
    # only in a flag the CPU's default routing ignores are equal
    assert rel["default"] != rel["base"]


def test_chip_smoke_imports_nothing_of_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    tops = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add(node.module.split(".")[0])
    assert tops <= {"importlib", "json", "pathlib", "subprocess", "sys",
                    "tempfile", "time", "torch", "eventad_tpu_torch"}, tops
    # importlib.import_module targets are strings: none names the reference
    assert "eventad_tpu." not in src.replace("eventad_tpu_torch", ""), src


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_cuda(tmp_path, alone):
    """Without a CUDA device (and, alone, without the package beside it)
    the smoke run exits non-zero and prints no result line."""
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path))
    res = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok"' not in res.stdout, res.stdout


@pytest.mark.parametrize("kw", [
    {},
    dict(batch_size=2, width=96, height=72, scale=1, event_buckets=(4096,),
         graph_lookback=512),
])
def test_config_geometry_matches(kw):
    a, b = Config(**kw), JaxConfig(**kw)
    for prop in ("model_width", "model_height", "radius_px", "delta_t_us",
                 "effective_radius"):
        assert getattr(a, prop) == getattr(b, prop), prop
    for fn in ("poolings", "grid_dims", "channels"):
        assert getattr(a, fn)() == getattr(b, fn)(), fn
    ta, tb = make_backbone_config(a), jax_bc(b)
    for field in ta._fields:
        assert getattr(ta, field) == getattr(tb, field), field
    # every field the port carries (training and evaluation ones included)
    # has the JAX package's value
    names = [f.name for f in dataclasses.fields(Config)]
    assert {"learning_rate", "weight_decay", "grad_clip", "lr_decay_factor",
            "lr_patience", "min_lr", "epochs", "seed", "threshold",
            "legacy_frame_collapse", "fps_warmup_batches", "fps_num_batches",
            "output_dir", "experiment_name", "test_checkpoint", "clip",
            "optimizer", "lr", "lr_scheduler", "no_aug_epochs",
            "synthetic_data"} <= set(names)
    for name in names:
        assert getattr(a, name) == getattr(b, name), name


def test_synthetic_batch_equals_reference():
    kw = dict(batch_size=2, width=96, height=72, scale=1,
              event_buckets=(2048,))
    got = make_synthetic_batch(Config(**kw), seed=5, boxes_per_item=3)
    want = jax_batch(JaxConfig(**kw), seed=5, boxes_per_item=3)
    for name in got._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_queue_ranks_match_native(rng):
    from eventad_tpu import native
    x = rng.randint(0, 5, 3000).astype(np.int32)
    y = rng.randint(0, 4, 3000).astype(np.int32)
    np.testing.assert_array_equal(queue_ranks(x, y, 5, 4),
                                  native.queue_ranks(x, y, 5, 4))
