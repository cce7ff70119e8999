"""The port's analytic roofline (``eventad_tpu_torch/utils/roofline.py``):
the same model FLOP and minimum-byte counts as the JAX package's, from the
port's own ``Config`` and ResNet tables, and rates against the H100's
peaks."""
import pytest
import torch

from eventad_tpu.config import Config as JaxConfig
from eventad_tpu.utils import roofline as jax_roofline
from eventad_tpu_torch.config import Config
from eventad_tpu_torch.utils import roofline

H100 = "NVIDIA H100 80GB HBM3"
BENCH_POINT = dict(batch_size=6, use_image=True, event_buckets=(16384,))


@pytest.mark.parametrize("kw,n_events", [
    (dict(BENCH_POINT, compute_dtype="bfloat16"), 16384),
    (dict(BENCH_POINT, compute_dtype="float32"), 16384),
    (dict(BENCH_POINT, compute_dtype="bfloat16", use_image=False), 16384),
    (dict(BENCH_POINT, compute_dtype="bfloat16", batch_size=12), 16384),
    (dict(BENCH_POINT, compute_dtype="bfloat16"), 32768),
    (dict(BENCH_POINT, compute_dtype="float32", img_net="resnet18",
          width=96, height=72, scale=1), None)])
def test_forward_roofline_equals_jax(kw, n_events):
    got = roofline.forward_roofline(Config(**kw), n_events)
    want = jax_roofline.forward_roofline(JaxConfig(**kw), n_events)
    assert got == want


def test_bench_point_counts():
    """105.92 GFLOP a batch, 91.40 of it the CNN; 1.035 GB in bf16."""
    r = roofline.forward_roofline(
        Config(**BENCH_POINT, compute_dtype="bfloat16"), 16384)
    assert r["gflops"] == 105.92 and r["by_stage"]["cnn"][0] == 91.399
    assert r["gbytes"] == 1.0347


def test_resnet50_at_224_is_8_2_gflop():
    """The published ResNet-50 count at 224x224 (4.1 G multiply-adds)."""
    convs, _ = roofline.resnet_conv_list("resnet50", 224, 224)
    flops = sum(2.0 * ho * wo * kh * kw * ci * co
                for kh, kw, ci, co, ho, wo in convs)
    assert flops == pytest.approx(8.2e9, rel=0.06)
    assert convs == jax_roofline.resnet_conv_list("resnet50", 224, 224)[0]


def test_roofline_rates_against_the_h100_peaks(monkeypatch):
    roof = roofline.forward_roofline(
        Config(**BENCH_POINT, compute_dtype="bfloat16"), 16384)
    ok = roofline.roofline_rates(roof, 10e-3, H100)
    assert ok["mfu"] == pytest.approx(roof["flops"] / 10e-3 / 989e12)
    assert ok["hbm_gbps_min"] == pytest.approx(roof["bytes"] / 10e-3 / 1e9)
    assert ok["mfu_peak_tflops"] == 989
    # bytes bind: 1.035 GB over 3.35 TB/s
    assert ok["roofline_bound_ms"] == pytest.approx(
        roof["bytes"] / 3.35e12 * 1e3)
    assert "roofline_warning" not in ok
    # an impossible time: faster than the HBM allows
    bad = roofline.roofline_rates(roof, 0.2e-3, H100)
    assert "H100" in bad["roofline_warning"]
    assert "989" in bad["roofline_warning"]
    # f32: TF32 while cuDNN may use it, else the f32 peak
    roof32 = roofline.forward_roofline(
        Config(**BENCH_POINT, compute_dtype="float32"), 16384)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert roofline.roofline_rates(roof32, 0.05, H100,
                                   "float32")["mfu_peak_tflops"] == 495
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    f32 = roofline.roofline_rates(roof32, 0.05, H100, "float32")
    assert f32["mfu_peak_tflops"] == 67
    assert f32["mfu"] == pytest.approx(roof32["flops"] / 0.05 / 67e12)
    # mfu over 1 at the f32 peak is flagged too
    assert "roofline_warning" in roofline.roofline_rates(
        roof32, 1e-3, H100, "float32")


def test_roofline_rates_refuse_another_card():
    roof = roofline.forward_roofline(Config(**BENCH_POINT), 16384)
    with pytest.raises(ValueError, match="H100"):
        roofline.roofline_rates(roof, 10e-3, "NVIDIA A100-SXM4-80GB")
