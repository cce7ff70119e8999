"""Each frozen copy equals the program's function as it stood when it was
copied: the traffic generator, the scoring forward's counts, the streaming
FLOPs and ``chip_smoke.py``'s bound rule."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmarks.frozen import counts, traffic
from benchmarks.reference.geometry import Geometry
from benchmarks.tests import cells
from eventad_tpu_torch.config import Config
from eventad_tpu_torch.data import fixtures


@pytest.mark.parametrize("kw", [
    dict(), dict(n_frames=5, n_objects=6, anomalous=True, toa_frame=2,
                 seed=11, events_per_window=5000, frame_scale=1)])
def test_traffic_equals_make_sequence(kw):
    cfg = Config()
    want = fixtures.make_sequence("s", cfg, **kw)
    got = traffic.make_sequence("s", cfg.model_width, cfg.model_height,
                                cfg.scale, **kw)
    for k in "xytp":
        np.testing.assert_array_equal(got["events"][k], want["events"][k])
    np.testing.assert_array_equal(got["timestamps"], want["timestamps"])
    np.testing.assert_array_equal(got["tracks"], want["tracks"])
    for a, b in zip(got["images"], want["images"]):
        np.testing.assert_array_equal(a, b)
    assert got["toa"] == want["toa"]


def _fields(name):
    return cells.config() if name == "small" else __import__("json").loads(
        (cells.HERE.parent / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["rol", "dota", "small"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_forward_counts_equal_roofline(name, dtype):
    from eventad_tpu_torch.utils.roofline import forward_roofline
    f = dict(_fields(name)["fields"])
    f["event_buckets"] = tuple(f["event_buckets"])
    geo = Geometry.of(f)
    cfg = Config(**f).replace(compute_dtype=dtype)
    for n in f["event_buckets"]:
        want = forward_roofline(cfg, n)
        got = counts.forward_roofline(geo, n, dtype)
        assert got["flops"] == want["flops"]
        assert got["bytes"] == want["bytes"]


def test_geometry_equals_config():
    for name in ("rol", "dota", "small"):
        f = dict(_fields(name)["fields"])
        f["event_buckets"] = tuple(f["event_buckets"])
        geo, cfg = Geometry.of(f), Config(**f)
        for attr in ("model_width", "model_height", "radius_px",
                     "delta_t_us", "effective_radius"):
            assert getattr(geo, attr) == getattr(cfg, attr), attr
        assert geo.channels() == cfg.channels()
        assert geo.grid_dims() == cfg.grid_dims()


def test_stream_flops_equal_flops_report():
    from eventad_tpu_torch.streaming.evaluate import flops_report
    f = dict(_fields("rol")["fields"], batch_size=1)
    f["event_buckets"] = tuple(f["event_buckets"])
    rep = flops_report(Config(**f), 16384, 512)
    geo = Geometry.of(f)
    assert counts.backbone_flops(geo, 16384, streaming_changed=512) == \
        pytest.approx(rep["delta_mflops"] * 1e6, rel=1e-12)
    assert counts.backbone_flops(geo, 16384) == \
        pytest.approx(rep["dense_mflops"] * 1e6, rel=1e-12)


def test_bound_rule_equals_chip_smoke():
    import chip_smoke as cs
    g = torch.Generator().manual_seed(0)
    pos = torch.zeros(2, 64, 3, dtype=torch.int32)
    pos[..., 2] = torch.sort(torch.randint(0, 50_000, (2, 64),
                                           generator=g)).values
    valid = torch.rand(2, 64, generator=g) > 0.2
    kw = dict(delta_t_us=10_000, lookback=16)
    out = (torch.zeros(2, 64, 16, dtype=torch.int32),)
    assert counts.search_ops((pos, valid), kw, out) == \
        cs.search_ops((pos, valid), kw, out)
    assert counts.all_bytes((pos, valid), kw, out) == \
        cs.all_bytes((pos, valid), kw, out)
    nbr = torch.randint(-1, 64, (64, 15), dtype=torch.int32, generator=g)
    prep = SimpleNamespace(nbr=nbr, u=torch.rand(64, 15, 2))
    pack = SimpleNamespace(taps=torch.zeros(15, 16, 40, dtype=torch.bfloat16),
                           c=33, cs=0, o=16, ab=torch.zeros(16, 4))
    pack2 = SimpleNamespace(taps=pack.taps, c=16, cs=33, o=16, ab=pack.ab)
    a = (torch.zeros(64, 33, dtype=torch.bfloat16), prep, pack, pack2,
         valid[0])
    out2 = torch.zeros(64, 16, dtype=torch.bfloat16)
    assert counts.level0_ops(a, {}, out2) == cs.level0_ops(a, {}, out2)
    assert counts.level0_bytes(a, {}, out2) == cs.level0_bytes(a, {}, out2)
    sprep = SimpleNamespace(
        mq=torch.rand(64, 25, generator=g) > 0.5, node_mask=valid[0],
        d_offs=torch.zeros(25, dtype=torch.int32),
        tap_mxy=torch.zeros(9, 2, dtype=torch.int32),
        tap_ptr=torch.zeros(10, dtype=torch.int32),
        tap_slots=torch.zeros(40, dtype=torch.int32),
        u=torch.rand(64, 25, 2), tap_idx=torch.arange(9))
    w = torch.zeros(25, 33, 16, dtype=torch.bfloat16)
    sa = (torch.zeros(64, 33, dtype=torch.bfloat16), sprep, w,
          torch.zeros(33, 16), torch.zeros(16), torch.zeros(16))
    skw = dict(skip=(torch.zeros(64, 33, dtype=torch.bfloat16),))
    assert counts.shift_ops(sa, skw, out2) == cs.shift_ops(sa, skw, out2)
    assert counts.shift_bytes(sa, skw, out2) == cs.shift_bytes(sa, skw, out2)
    assert counts.upsample_ops((), {}, out2) == cs.upsample_ops((), {}, out2)
