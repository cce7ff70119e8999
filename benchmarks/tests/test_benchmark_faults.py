"""Each cell's run, its look for a card skipped, with the timed path broken
underneath: ``correct`` has to come out false under the cell's own limits,
once for each fault the cell can have (one card: no exchange between
chips).  And, on the card, the control of each cell (the reference in the
next lower precision in the program's place) fails the cell's limits
where the program passes them."""
import contextlib
import json

import pytest
import torch

from benchmarks import faults
from benchmarks.harness import core
from benchmarks.loops import score, stream, train_head
from benchmarks.tests import cells

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77


def _run(loop, cell, capsys, seconds=1.5):
    loop.run(cell, SEED, seconds, False, CPU, core.process_start())
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


_limits = cells.limits


def test_score_sound_run_is_correct(capsys):
    out = _run(score, cells.cell("rol.score", "score", _limits("rol.score")),
               capsys)
    assert out["correct"] and out["failed"] == 0


@pytest.mark.parametrize("fault", ["half_the_batch", "answer_altered"])
def test_score_faults(capsys, fault):
    with faults.score(fault):
        out = _run(score, cells.cell("rol.score", "score",
                                     _limits("rol.score")), capsys)
    assert not out["correct"], out["compared"]


@pytest.mark.parametrize("fault", [None, "state_unchanged",
                                   "answer_altered"])
def test_stream_faults(capsys, fault):
    with faults.stream(fault) if fault else contextlib.nullcontext():
        out = _run(stream, cells.cell("rol.stream", "stream",
                                      _limits("rol.stream")), capsys)
    assert out["correct"] == (fault is None), out["compared"]


@pytest.mark.parametrize("fault", [None, "state_unchanged",
                                   "half_the_batch", "answer_altered"])
def test_train_faults(capsys, fault):
    with faults.train_head(fault) if fault else contextlib.nullcontext():
        out = _run(train_head, cells.cell("rol.train_head", "train_head",
                                          _limits("rol.train_head"),
                                          "float32"), capsys)
    assert out["correct"] == (fault is None), out["compared"]


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in json.loads(
    (cells.HERE.parents[1] / "BENCHMARK.json").read_text())["workloads"]])
def test_control_fails_where_the_program_passes(card, name):
    """At the cell's own sizes on the card: the program within every limit,
    the control over one of them."""
    cell = core.load_cell(name)
    loop = {"score": score, "stream": stream,
            "train_head": train_head}[cell.mix["loop"]]
    out = loop.calibrate(cell, SEED, 3.0, card)
    lims = list(cell.limits.values())
    def numbers(x):
        return [x["mean"]] if isinstance(x, dict) else list(x)
    prog, ctrl = numbers(out["program"]), numbers(out["control"])
    assert all(p <= m for p, m in zip(prog, lims)), out
    assert any(c > m for c, m in zip(ctrl, lims)), out
