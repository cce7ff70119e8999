"""The port's incremental stream (``streaming/incremental``: ``append`` then
``read_scores``, as the benchmark's ``loops/stream`` drives it) against the
benchmark's plain reference (``benchmarks/reference/stream.py``), on the
CPU in f32 with seeded random weights, at two small geometries:

- ``rol``'s shape: a 3:2 field at scale 3 (96x72), chunks shorter than the
  lookback (256 and 512);
- ``dota``'s shape: a 16:9 field at scale 4 (96x54), chunks as long as the
  lookback (128 and 128), so that each destination's window reaches back
  across the whole previous chunk.

Each ring holds 2 048 events, and the reference rebuilds it from the
fewest whole chunks that hold ``ring + 2 x lookback`` rows.  The sampled
steps' logits and new track state equal the reference's exactly.  Nothing
of JAX is used here."""
import pytest
import torch

from benchmarks.harness import core
from benchmarks.loops import stream
from benchmarks.reference import model as rmodel

import _torch_threads  # noqa: F401  (one intra-op thread)

RING = 2048
SEED = 2 ** 31 + 22
# (fields, frame interval us, chunk)
SHAPES = {
    "rol": (dict(width=288, height=216, scale=3, graph_lookback=512),
            50_000, 256),
    "dota": (dict(width=384, height=216, scale=4, graph_lookback=128),
             100_000, 128),
}


def _cell(shape):
    fields, frame_us, chunk = SHAPES[shape]
    lookback = fields["graph_lookback"]
    replay = -(-(RING + 2 * lookback) // chunk)
    config = {
        "name": shape, "fields": dict(fields, batch_size=1,
                                      event_buckets=[RING]),
        "dtypes": {"features": "float32", "head": "float32",
                   "train": "float32"},
        "tf32": False,
        "traffic": {"frame_us": frame_us, "events_per_window": 2600}}
    # the first window chunk is ring / chunk + warmup_chunks, and the
    # reference's replay starts ``replay`` chunks before it
    mix = {"loop": "stream", "frames": 12, "objects": 4, "toa_frame": 6,
           "chunk": chunk, "ring": RING,
           "warmup_chunks": max(replay - RING // chunk, 1),
           "sample_chunks": 3, "replay": replay, "trace_units": 2}
    return core.Cell(name=f"{shape}.stream", config=config, mix=mix,
                     limits={}, chips=1, end_to_end=[], per_layer=[])


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_stream_equals_reference_f32(shape):
    cell = _cell(shape)
    s = stream.Session(cell, SEED, torch.device("cpu"))
    records = []
    for _ in range(4):
        c, logits, before = s.chunk()
        records.append((c, logits, before,
                        (s.state.h_event, s.state.h_coord)))
    rmodel.strict_f32()
    pick = stream.sample(records, cell.mix["sample_chunks"], SEED)
    lgaps, sgaps, refs = stream.reference_gaps(s, records, pick,
                                               cell.mix["replay"])
    assert lgaps == [0.0] * len(pick)
    assert sgaps == [0.0] * len(pick)
    # the comparison sees something: slots with outputs in every step
    assert all(bool((lg != 0).any()) for lg, _ in refs)
