"""The port's headline benchmark module (``python -m
eventad_tpu_torch.bench``): on the CPU at a small geometry it prints the
device line and its two JSON records with the root ``bench.py``'s keys;
without a card and without ``--device cpu`` it raises."""
import json

import pytest

from eventad_tpu_torch import bench

import _torch_threads  # noqa: F401  (one intra-op thread)

HEADLINE = {"metric", "value", "unit", "vs_baseline", "batch_ms",
            "pipelined_bboxes_per_sec", "pipelined_vs_baseline",
            "pipelined_ms_per_batch", "frames_per_sec", "events_per_item",
            "device", "power_limit_w"}
TRAINING = {"train_items_per_sec", "train_ms_per_batch",
            "train_compute_dtype"}


def test_bench_prints_both_records_on_the_cpu(monkeypatch, capsys):
    # fewer timed calls: the records' keys and counting are under test
    for name, n in (("WARMUP", 1), ("ITERS", 2), ("TRAIN_WARMUP", 1),
                    ("TRAIN_ITERS", 2)):
        monkeypatch.setattr(bench, name, n)
    bench.main(["512", "float32", "--device", "cpu", "--width", "96",
                "--height", "72", "--scale", "1", "--batch_size", "2",
                "--use_image", "false", "--graph_lookback", "128"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "cpu"
    first, second = (json.loads(line) for line in lines[1:])
    assert set(first) == HEADLINE
    assert set(second) == HEADLINE | TRAINING
    assert {k: second[k] for k in HEADLINE} == first
    assert first["metric"] == "inference_bboxes_per_sec"
    assert first["unit"] == "bboxes/s"
    assert first["events_per_item"] == 512
    assert first["device"] == "cpu" and first["power_limit_w"] is None
    # both frames' boxes: 2 items x 6 boxes x 2 frames
    assert first["value"] == pytest.approx(24 / first["batch_ms"] * 1e3)
    assert first["vs_baseline"] == pytest.approx(
        first["value"] / bench.BASELINE_FPS)
    assert second["train_compute_dtype"] == "float32"
    assert second["train_items_per_sec"] > 0


def test_bench_raises_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["512"])
