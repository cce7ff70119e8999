"""The PyTorch port imports no JAX-side module, and its configuration and
synthetic batches equal the JAX package's."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from eventad_tpu.config import Config as JaxConfig
from eventad_tpu.data.synthetic import make_synthetic_batch as jax_batch
from eventad_tpu.models.backbone import make_backbone_config as jax_bc
from eventad_tpu_torch.config import Config
from eventad_tpu_torch.data.batching import queue_ranks
from eventad_tpu_torch.data.synthetic import make_synthetic_batch
from eventad_tpu_torch.models.backbone import make_backbone_config

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import eventad_tpu_torch
pkg = eventad_tpu_torch
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules
             if n.split('.')[0] in ('jax', 'jaxlib', 'yaml', 'ml_dtypes',
                                    'eventad_tpu', 'triton'))
print('MODULES', sum(n.startswith(pkg.__name__) for n in sys.modules))
print('BAD', bad)
"""


def test_port_imports_no_jax_yaml_or_reference_package():
    res = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert "BAD []" in res.stdout, res.stdout
    n_mods = int(res.stdout.split("MODULES")[1].split()[0])
    assert n_mods >= 20, res.stdout


def test_chip_smoke_imports_nothing_of_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    tops = set()
    for node in ast.walk(ast.parse(src)):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add(node.module.split(".")[0])
    assert tops <= {"importlib", "json", "pathlib", "subprocess", "sys",
                    "time", "torch", "eventad_tpu_torch"}, tops
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
