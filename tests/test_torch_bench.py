"""The port's headline benchmark module (``python -m
eventad_tpu_torch.bench``): on the CPU at a small geometry it prints the
device line and its JSON records with the root ``bench.py``'s keys (the
headline, the model's analytic counts, the training figure; no device-time
key); without a card and without ``--device cpu`` it raises.  The
device-time functions it uses on the card raise on the CPU."""
import json

import pytest

from eventad_tpu_torch import bench
from eventad_tpu_torch.config import Config
from eventad_tpu_torch.utils import devtime
from eventad_tpu_torch.utils.roofline import forward_roofline

import _torch_threads  # noqa: F401  (one intra-op thread)

HEADLINE = {"metric", "value", "unit", "vs_baseline", "batch_ms",
            "pipelined_bboxes_per_sec", "pipelined_vs_baseline",
            "pipelined_ms_per_batch", "frames_per_sec", "events_per_item",
            "device", "power_limit_w"}
MODEL = {"model_gflops_per_batch", "model_gbytes_min_per_batch"}
TRAINING = {"train_items_per_sec", "train_ms_per_batch",
            "train_compute_dtype"}
DEVICE_TIME = {"scan_device_ms_per_batch", "scan_bboxes_per_sec",
               "scan_vs_baseline", "est_rtt_ms", "mfu", "mfu_peak_tflops",
               "hbm_gbps_min", "roofline_bound_ms", "roofline_warning",
               "trace_device_ms_per_batch"}


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
    first, second, third = (json.loads(line) for line in lines[1:])
    assert set(first) == HEADLINE
    assert set(second) == HEADLINE | MODEL
    assert set(third) == HEADLINE | MODEL | TRAINING
    assert not DEVICE_TIME & set(third)
    assert {k: second[k] for k in HEADLINE} == first
    assert {k: third[k] for k in HEADLINE | MODEL} == second
    roof = forward_roofline(Config(width=96, height=72, scale=1,
                                   batch_size=2, use_image=False,
                                   compute_dtype="float32",
                                   graph_lookback=128), 512)
    assert second["model_gflops_per_batch"] == roof["flops"] / 1e9
    assert second["model_gbytes_min_per_batch"] == roof["bytes"] / 1e9
    assert first["metric"] == "inference_bboxes_per_sec"
    assert first["unit"] == "bboxes/s"
    assert first["events_per_item"] == 512
    assert first["device"] == "cpu" and first["power_limit_w"] is None
    # both frames' boxes: 2 items x 6 boxes x 2 frames
    assert first["value"] == pytest.approx(24 / first["batch_ms"] * 1e3)
    assert first["vs_baseline"] == pytest.approx(
        first["value"] / bench.BASELINE_FPS)
    assert third["train_compute_dtype"] == "float32"
    assert third["train_items_per_sec"] > 0


def test_bench_raises_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main(["512"])


@pytest.mark.parametrize("call", [
    lambda: devtime.graph_device_ms(lambda: None),
    lambda: devtime.trace_device_ms(lambda: None),
    lambda: devtime.dispatch_floor_ms(),
    lambda: devtime.capture(lambda: None),
    lambda: devtime.replay_ms(None)],
    ids=["graph_device_ms", "trace_device_ms", "dispatch_floor_ms",
         "capture", "replay_ms"])
def test_device_times_raise_on_the_cpu(call):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_trace_union_merges_overlapping_device_intervals():
    """A call's busy time counts time covered by several device events
    (kernels on two streams, a copy beside a kernel) once."""
    assert devtime._union_us([(5, 6), (0, 2), (1, 3), (2.5, 2.8)]) == 4
    assert devtime._union_us([(0, 10), (2, 3)]) == 10
    assert devtime._union_us([]) == 0
