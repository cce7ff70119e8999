"""The frozen plain reference against the port's CPU path at the small
test geometry: with the features in f32, as the port's CPU route runs
them, the reference's batch logits, its collate and its stream (logits
and track state, chunk by chunk) equal the program's."""
import numpy as np
import torch

from benchmarks.loops import score, stream
from benchmarks.reference import data as rdata
from benchmarks.tests import cells

CPU = torch.device("cpu")


def test_score_reference_equals_port_f32():
    cell = cells.cell("rol.score", "score", {"logit_gap_mean": 1.0},
                      "float32")
    out = score.calibrate(cell, 5, 1.0, CPU)
    assert out["program"]["max"] == 0.0
    assert out["control"]["mean"] > 0.0


def test_reference_collate_equals_port():
    from eventad_tpu_torch.data.batching import collate
    cell = cells.cell("rol.score", "score", {"logit_gap_mean": 1.0})
    (geo, cfg, _, _, _, _, _, seqs, ds, _) = score.build(cell, 9, CPU)
    items = [ds[0], ds[5]]
    batch, meta = collate(items, cfg)
    byname = {s["name"]: s for s in seqs}
    ref = rdata.collate([rdata.cut(byname[n], f - 1, geo)
                         for n, f in zip(meta.sequences, meta.frame_ids)],
                        geo)
    for k in ("pos", "polarity", "valid", "rank", "image", "boxes",
              "box_present", "box_labels"):
        np.testing.assert_array_equal(getattr(batch, k).numpy(), ref[k],
                                      err_msg=k)
    assert ref["n_boxes"] == int(batch.bbox_mask.sum()
                                 + batch.bbox0_mask.sum())


def test_stream_reference_equals_port_f32():
    cell = cells.cell("rol.stream", "stream",
                      {"logit_gap": 1.0, "state_gap": 1.0}, "float32")
    out = stream.calibrate(cell, 5, 1.0, CPU)
    assert out["program"] == [0.0, 0.0]
    assert min(out["control"]) > 0.0
