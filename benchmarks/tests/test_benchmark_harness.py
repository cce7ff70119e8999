"""The harness: cells, mixes, limits and metrics found by name, the
contract's form of ``BENCHMARK.json``, the trace's reduction on a
synthetic trace, the window's arithmetic, and what the benchmark may
import."""
import ast
import json
import re
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmarks.harness import core, trace as tr

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmarks"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_every_cell_finds_its_files():
    for w in SPEC["workloads"]:
        cell = core.load_cell(w["name"])
        assert cell.end_to_end and cell.per_layer
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        loop = __import__(f"benchmarks.loops.{cell.mix['loop']}",
                          fromlist=["run"])
        assert callable(loop.run) and callable(loop.calibrate)
        assert cell.limits and all(v > 0 for v in cell.limits.values())
        for m in cell.per_layer:
            assert core.reader(m["name"])({}) is None, m["name"]


def test_contract_form():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmarks"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmarks/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == \
            c["name"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (BENCH / "mixes" / f"{w['traffic']}.json").exists()
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert NAME.match(m["name"]) and m["name"] not in names
        names.add(m["name"])
        assert set(m.get("workloads", [])) <= cells
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert (BENCH / "metrics" / f"{m['name']}.py").exists()
    assert len(json.dumps(SPEC)) < 64 * 1024


def _event(name, start, end, device):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=False)


def test_trace_union_and_idle_share():
    """Two units of 100 us each; device work 0-30 and 20-40 (one busy
    stretch of 40), 150-160, and an overlap inside it: busy 50 of 200."""
    cuda, cpu = "DeviceType.CUDA", "DeviceType.CPU"
    events = [
        _event("bench/forward", 0, 100, cpu),
        _event("bench/copy_out", 100, 200, cpu),
        _event("search_kernel<15>", 0, 30, cuda),
        _event("k_b", 20, 40, cuda),
        _event("k_b", 25, 35, cuda),
        _event("Memcpy DtoH", 150, 160, cuda),
    ]
    red = tr.reduce(SimpleNamespace(events=lambda: events), 2,
                    {"K1": 3e-6})
    assert red["busy_s"] == pytest.approx(50e-6)
    assert red["window_s"] == pytest.approx(200e-6)
    assert red["idle_pct"] == pytest.approx(75.0)
    assert red["device_ops"] == 2.0
    assert red["busy_ms"] == pytest.approx(0.025)
    assert red["kernels"]["K1"]["roofline_pct"] == pytest.approx(10.0)
    assert red["breakdown"]["idle_gaps"][0] == ["forward",
                                                pytest.approx(110e-6)]
    assert red["breakdown"]["device_ops"][0][0] == "search_kernel<15>"


def test_window_arithmetic_sees_a_stall(monkeypatch):
    """A stall in the window lowers the rate of boxes and raises the 95th
    percentile of the chunks' times."""
    import time
    import torch
    from benchmarks.loops import score, stream
    from benchmarks.tests import cells
    from eventad_tpu_torch.models import dagr
    from eventad_tpu_torch.streaming import incremental as inc
    dev = torch.device("cpu")
    s = score.Session(cells.cell("rol.score", "score", {}), 3, dev)
    base = s.window(1.0)
    fwd = dagr.model_forward
    calls = []

    def stalled(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            time.sleep(1.5)
        return fwd(*a, **kw)
    monkeypatch.setattr(dagr, "model_forward", stalled)
    slow = s.window(1.0)
    assert slow["bboxes_per_s"] < 0.8 * base["bboxes_per_s"]

    st = stream.Session(cells.cell("rol.stream", "stream", {}), 3, dev)
    base = st.window(1.5)
    step, n = st.step, []

    def stalled_step(*a, **kw):
        n.append(1)
        if len(n) % 2 == 0:
            time.sleep(0.4)
        return step(*a, **kw)
    st.step = stalled_step
    slow = st.window(1.5)
    assert slow["chunk_ms_p95"] > base["chunk_ms_p95"] + 250
    assert inc  # the program's stream module was the one driven


def test_p95():
    assert core.p95(list(range(101))) == pytest.approx(95.0)
    assert core.p95([4.0]) == 4.0


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield node.args[0].value.split(".")[0]


def test_imports():
    """Top-level names compared whole: no JAX and no JAX package anywhere
    in the benchmark; nothing of the program in the reference and the
    frozen copies (the tests compare the copies with the program)."""
    for path in BENCH.rglob("*.py"):
        names = set(_imports(path))
        assert not names & {"jax", "jaxlib", "flax", "eventad_tpu"}, path
        if path.parent.name in ("reference", "frozen"):
            assert "eventad_tpu_torch" not in names, path


def test_no_card_no_result(tmp_path):
    """Without a card, and in a directory holding only the benchmark's
    files, a run exits non-zero and prints no result line."""
    import shutil
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:
            shutil.copytree(BENCH, tmp_path / "benchmarks",
                            ignore=shutil.ignore_patterns("__pycache__"))
            shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
        r = subprocess.run(
            [sys.executable, "-m", "benchmarks.run", "--workload",
             "rol.score", "--seed", "2147483999", "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=120)
        assert r.returncode != 0
        assert '"correct"' not in r.stdout


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "eventad_tpu_torch_like", sys)
    assert core.forbidden_modules() == [] or \
        "eventad_tpu_torch_like" not in core.forbidden_modules()
    monkeypatch.setitem(sys.modules, "eventad_tpu.models", sys)
    assert core.forbidden_modules() == ["eventad_tpu"]
