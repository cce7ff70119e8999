"""Every stream cell's mix fits its configuration: the reference rebuilds
the program's ring only from ``ring + 2 x lookback`` appended rows
(``reference/stream``), so the ``replay`` chunks before a sampled step
have to hold that many; and the generated sequence has to hold the ring,
the warm-up, the traced segment, one chunk more and a window of
``run_seconds`` at the fastest chunk it is held to, or the loop raises
"the stream ran out of events"."""
import json
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmarks"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
STREAM_LOOPS = ("stream", "stream_detect")
# the fastest chunk a window has to be fed for: under half of the fastest
# chunk_ms_p95 a stream cell has read (16.5 ms, dagr_s50.stream_detect on
# an H100)
FASTEST_CHUNK_S = 0.007


def _stream_cells():
    configs = {c["name"]: c for c in SPEC["configs"]}
    out = []
    for w in SPEC["workloads"]:
        mix = json.loads((BENCH / "mixes" / f"{w['traffic']}.json")
                         .read_text())
        if mix["loop"] in STREAM_LOOPS:
            cfg = json.loads((ROOT / configs[w["config"]]["file"])
                             .read_text())
            out.append(pytest.param(mix, cfg, id=w["name"]))
    return out


@pytest.mark.parametrize("mix,cfg", _stream_cells())
def test_replay_reaches_the_rings_history(mix, cfg):
    lookback = cfg["fields"]["graph_lookback"]
    assert mix["replay"] * mix["chunk"] >= mix["ring"] + 2 * lookback


@pytest.mark.parametrize("mix,cfg", _stream_cells())
def test_frames_hold_the_ring_warmup_trace_and_window(mix, cfg):
    tr = cfg["traffic"]
    # the generator's rate before the anomaly: events_per_window events
    # each 50 ms (frozen/traffic.py), whatever the frame interval; the
    # first frame's window emits nothing.  The anomalous object's extra
    # events (20-37 % more in all, for rol and dota) are left as margin
    events = (mix["frames"] - 1) * tr["events_per_window"] * 20 \
        * tr["frame_us"] / 1e6
    window = SPEC["run_seconds"] / FASTEST_CHUNK_S
    need = mix["ring"] + (mix["warmup_chunks"] + mix["trace_units"] + 1
                          + window) * mix["chunk"]
    assert events >= need


def test_every_stream_loop_cell_is_checked():
    ids = [p.id for p in _stream_cells()]
    assert {"rol.stream", "dagr_s50.stream_detect", "dota.stream"} <= \
        set(ids)
