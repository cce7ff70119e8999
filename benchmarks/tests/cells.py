"""Small cells for the CPU tests: the test geometry of ``small.json`` (a
96 x 72 image, batch 2, buckets of 1 024 to 4 096 events) under the
cells' own mixes, shortened, with the cells' own limits."""
import json
from pathlib import Path

from benchmarks.harness import core

HERE = Path(__file__).parent
MIXES = HERE.parent / "mixes"
SCORE_MIX = dict(sequences=3, frames=5, warmup_batches=2, sample_batches=3,
                 trace_units=2)
STREAM_MIX = dict(frames=12, chunk=256, ring=2048, warmup_chunks=14,
                  sample_chunks=3, replay=13, toa_frame=6, trace_units=2)
TRAIN_MIX = dict(sequences=3, frames=5, batches=5, trace_units=2)


def config(features="bfloat16"):
    c = json.loads((HERE / "small.json").read_text())
    c["dtypes"]["features"] = features
    return c


SHORT = {"score": SCORE_MIX, "stream": STREAM_MIX, "train_head": TRAIN_MIX}
# the end-to-end metric of each loop, for a cell ``BENCHMARK.json`` lacks
E2E = {"score": "bboxes_per_s", "stream": "chunk_ms_p95",
       "train_head": "train_items_per_s"}


def limits(name):
    """The limits file of cell ``name``."""
    return json.loads((HERE.parent / "limits" / f"{name}.json").read_text())


def cell(name, loop, limits, features="bfloat16"):
    """Cell ``name`` at the test geometry under a shortened ``loop`` mix;
    its metrics from ``BENCHMARK.json`` where it is listed there."""
    mix = json.loads((MIXES / f"{loop}.json").read_text())
    mix.update(SHORT[loop])
    listed = {w["name"] for w in json.loads(
        (HERE.parents[1] / "BENCHMARK.json").read_text())["workloads"]}
    if name in listed:
        spec = core.load_cell(name)
        e2e, per_layer = spec.end_to_end, spec.per_layer
    else:
        e2e = [{"name": E2E[loop], "unit": "-"}, {"name": "setup_s",
                                                  "unit": "s"}]
        per_layer = []
    return core.Cell(name=name, config=config(features), mix=mix,
                     limits=limits, chips=1, end_to_end=e2e,
                     per_layer=per_layer)
