"""Traffic from the frozen generator and a seed.

Every seed gives the same set of item sizes in another order: the sizes
form a fixed multiset (a share of the items just over the configuration's
bucket, the rest spread below it), permuted by the seed, and each frame
window of a generated sequence keeps that many of its events, drawn
uniformly (the events stay on the moving edges).  So a seed changes which
events and in which order, not how much work a run holds."""
from __future__ import annotations

import numpy as np

from ..frozen.traffic import make_sequence
from ..reference.geometry import Geometry


def item_sizes(n_items: int, sizes: dict) -> np.ndarray:
    """The fixed multiset of events per item: ``over_share`` of the items
    evenly over ``over_events`` and the rest evenly over ``item_events``
    (inclusive ranges)."""
    n_over = int(round(sizes["over_share"] * n_items))
    lo, hi = sizes["item_events"]
    olo, ohi = sizes["over_events"]
    base = np.linspace(lo, hi, n_items - n_over)
    over = np.linspace(olo, ohi, n_over)
    return np.round(np.concatenate([base, over])).astype(np.int64)


def _trim(seq: dict, targets, rng) -> dict:
    """``seq`` with frame window ``j`` holding ``targets[j]`` of its
    events."""
    ev, ts = seq["events"], seq["timestamps"]
    bounds = np.searchsorted(ev["t"], ts)
    keep = []
    for j, want in enumerate(targets):
        lo, hi = bounds[j], bounds[j + 1]
        if hi - lo < want:
            raise ValueError(f"{seq['name']}: window {j} holds {hi - lo} "
                             f"events, {want} wanted; raise "
                             f"events_per_window")
        keep.append(lo + np.sort(rng.choice(hi - lo, want, replace=False)))
    idx = np.concatenate(keep)
    return dict(seq, events={k: v[idx] for k, v in ev.items()})


def sequences(geo: Geometry, traffic: dict, mix: dict, seed: int,
              n_sequences: int, n_objects: int = None):
    """``n_sequences`` generated sequences of ``mix["frames"]`` frames at
    model size, every ``mix["anomalous_every"]``-th anomalous, each frame
    window holding its share of the fixed multiset of sizes.  ``traffic``:
    the configuration's rates (``frame_us``, ``events_per_window``) and
    sizes.  Returns ``(sequences, sizes)``, ``sizes`` the events of each
    frame pair, sequence by sequence."""
    rng = np.random.default_rng(seed)
    n_frames = mix["frames"]
    sizes = rng.permutation(item_sizes(n_sequences * (n_frames - 1),
                                       traffic))
    out = []
    for i in range(n_sequences):
        seq = make_sequence(
            f"seq{i:03d}", geo.model_width, geo.model_height, geo.scale,
            n_frames=n_frames, n_objects=n_objects or mix["objects"],
            anomalous=i % mix["anomalous_every"] == 0,
            toa_frame=mix["toa_frame"], seed=int(rng.integers(2 ** 31)),
            events_per_window=traffic["events_per_window"], frame_scale=1,
            frame_us=traffic["frame_us"])
        out.append(_trim(seq, sizes[i * (n_frames - 1):
                                    (i + 1) * (n_frames - 1)], rng))
    return out, sizes
