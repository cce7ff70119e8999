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
from eventad_tpu_torch.test import main as evaluate_main
from eventad_tpu_torch.train import main as train_main

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
                                    'sklearn', 'h5py'))
print('MODULES', sum(n.startswith(pkg.__name__) for n in sys.modules))
print('BAD', bad)
"""


def test_port_imports_no_jax_yaml_or_reference_package():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    n_mods = int(res.stdout.split("MODULES")[1].split()[0])
    assert n_mods >= 32, res.stdout     # the training modules included


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
    for main in (train_main, evaluate_main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--batch_size", "1"])


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
            "output_dir", "experiment_name", "test_checkpoint"} <= set(names)
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
