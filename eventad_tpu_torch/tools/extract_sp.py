"""Sequence-parallel feature extraction of one long event stream (the user
entry point of ``parallel/seq_shard.py``; counterpart of the root
``tools/extract_sp.py``).

    python -m eventad_tpu_torch.tools.extract_sp --devices 2 --events 4096 \\
        --graph_lookback 256 --check --out feats.npz --device cpu

Starts ``--devices`` processes (gloo on the CPU, NCCL with one card a
process), cuts the stream into one time block a process with the lookback
halo of ``parallel/seq_shard.py``, and writes the pooled ``(out3, out4)``
feature tables the anomaly head reads.  Real streams: ``--events_npz``
with ``pos [N, 3]`` int32 (x, y, t_us; time-sorted), ``polarity [N]``
float32 and, optionally, ``image [H, W, 3]`` float32 in [0, 1].  Trained
weights: ``--checkpoint`` (a ``train`` checkpoint of the port).
``--check`` also runs the single-process streaming computation on rank 0
and requires the sharded features to match it (rel < 1e-5).  Runs on the
CUDA card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..config import Config
from ..models.dagr import graph_static_config, init_model, resolve_device
from ..parallel.launch import spawn
from ..parallel.mesh import make_mesh
from ..parallel.seq_shard import check_blocks, seq_sharded_features
from ..streaming import incremental as inc
from ..utils import checkpoint as ckpt

CHECK_TOL = 1e-5


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=0,
                    help="processes over the event axis (0: one a card, "
                         "one on the CPU)")
    ap.add_argument("--events", type=int, default=16384,
                    help="synthetic stream length (ignored with "
                         "--events_npz)")
    ap.add_argument("--events_npz", default=None,
                    help="npz with pos [N,3] int32, polarity [N] f32, "
                         "optional image [H,W,3] f32")
    ap.add_argument("--checkpoint", default=None,
                    help="the port's train checkpoint to load weights from")
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--height", type=int, default=72)
    ap.add_argument("--scale", type=int, default=1)
    ap.add_argument("--use_image", default="true",
                    choices=("true", "false"))
    ap.add_argument("--graph_lookback", type=int, default=None,
                    help="lookback override (block must be >= 2*lookback)")
    ap.add_argument("--out", default=None, help="output npz path")
    ap.add_argument("--check", action="store_true",
                    help="require equality with the single-process path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None)
    return ap


def _stream(a, d: int):
    """``(cfg, pos, pol, valid, image)``: the stream padded at its tail to
    a multiple of ``d`` (masked invalid)."""
    use_image = a.use_image == "true"
    rng = np.random.RandomState(a.seed)
    if a.events_npz:
        data = np.load(a.events_npz)
        pos = np.asarray(data["pos"], np.int32)
        pol = np.asarray(data["polarity"], np.float32)
        img = (np.asarray(data["image"], np.float32)
               if "image" in data else None)
        if img is None and use_image:
            raise SystemExit("--use_image true but no image in the npz")
    else:
        pos = np.zeros((a.events, 3), np.int32)
        pol = np.zeros((a.events,), np.float32)
        img = None
    n = len(pos)
    pad = -n % d
    if pad:
        pos = np.concatenate([pos, np.repeat(pos[-1:], pad, 0)])
        pol = np.concatenate([pol, np.zeros((pad,), np.float32)])
    valid = np.arange(n + pad) < n
    kw = dict(batch_size=1, width=a.width, height=a.height, scale=a.scale,
              use_image=use_image, event_buckets=(n + pad,))
    if a.graph_lookback is not None:
        kw["graph_lookback"] = a.graph_lookback
    cfg = Config(**kw)
    if not a.events_npz:
        w, h = cfg.model_width, cfg.model_height
        pos[:, 0] = rng.randint(0, w, n + pad)
        pos[:, 1] = rng.randint(0, h, n + pad)
        pos[:, 2] = 1_000_000 + np.sort(rng.randint(0, 200_000, n + pad))
        pol[:] = rng.choice([-1.0, 1.0], n + pad).astype(np.float32)
        if use_image:
            img = rng.rand(h, w, 3).astype(np.float32)
    return cfg, pos, pol, valid, img


def extract(argv, devices: int) -> dict:
    """One rank's part (run by ``spawn``): the sharded features; on rank 0
    the ``--out`` file and the ``--check``.  Returns the lines to print."""
    import torch.distributed as dist
    a = parser().parse_args(argv)
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if a.device != "cpu" else torch.device("cpu")
    cfg, pos, pol, valid, img = _stream(a, devices)
    n = len(pos)
    model, bc, mc = init_model(cfg, torch.Generator().manual_seed(0), dev)
    lines = []
    if a.checkpoint:
        ckpt.load_checkpoint(a.checkpoint, model, device=dev)
        lines.append(f"loaded weights from {a.checkpoint}")
    gsc = graph_static_config(cfg)
    state = inc.init_incremental_state(n, bc, mc, cfg.max_neighbors, dev)
    if cfg.use_image:
        state = inc.update_image(model, state, torch.from_numpy(img).to(dev))
    pos_t, pol_t, val_t = (torch.from_numpy(x).to(dev)
                           for x in (pos, pol, valid))
    blk = n // devices
    lines.append(f"extracting over {devices} processes on {dev.type} "
                 f"(block {blk}, lookback halo "
                 f"{min(cfg.graph_lookback, blk)}) ...")
    outs = seq_sharded_features(model, bc, gsc, pos_t, pol_t, val_t,
                                state.image_feats, make_mesh(str(devices)))
    out3, out4 = outs
    lines.append(f"out3: {tuple(out3.x.shape)} ({int(out3.node_mask.sum())} "
                 f"active cells)  out4: {tuple(out4.x.shape)} "
                 f"({int(out4.node_mask.sum())} active cells)")
    if dist.get_rank() != 0:
        return dict(lines=[])
    if a.check:
        st = inc.insert_raw(state, pos_t, pol_t, int(valid.sum()))
        refresh, _ = inc.make_incremental_step(model, bc, mc, gsc,
                                               n_chunk=min(256, n), n_buf=n)
        st = refresh(st)
        ref = inc.pooled_backbone_outs(model, bc, st,
                                       inc.norm_pos(st.pos, st.t_now, gsc),
                                       gsc)
        worst = 0.0
        for lvl, (gr, gs) in enumerate(zip(ref, outs)):
            if not torch.equal(gr.node_mask, gs.node_mask):
                raise AssertionError(f"level {lvl}: active cells differ")
            m = gr.node_mask[:, None]
            xr = torch.where(m, gr.x.float(), 0.0)
            xs = torch.where(m, gs.x.float(), 0.0)
            rel = float((xr - xs).abs().max() / (xr.abs().max() + 1e-6))
            worst = max(worst, rel)
            if not rel < CHECK_TOL:
                raise AssertionError(f"level {lvl}: sharded features differ "
                                     f"by {rel} of their scale")
        lines.append(f"check OK: sharded == single-process (worst rel "
                     f"{worst:.2e})")
    if a.out:
        np.savez(a.out, **{f"{name}_{k}": v.float().cpu().numpy()
                           if v.is_floating_point() else v.cpu().numpy()
                           for name, g in (("out3", out3), ("out4", out4))
                           for k, v in (("x", g.x), ("pos", g.pos),
                                        ("mask", g.node_mask))})
        lines.append(f"features written to {a.out}")
    return dict(lines=lines)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    a = parser().parse_args(argv)
    dev = resolve_device(a.device)
    d = a.devices or (torch.cuda.device_count() if dev.type == "cuda"
                      else 1)
    cfg, pos, *_ = _stream(a, d)
    try:
        check_blocks(len(pos), d, cfg.graph_lookback)
    except ValueError as e:
        raise SystemExit(f"{e}: use fewer devices, more events, or a "
                         f"smaller --graph_lookback") from None
    results = spawn("eventad_tpu_torch.tools.extract_sp:extract", d,
                    kwargs=dict(argv=argv, devices=d), device=dev.type)
    for line in results[0]["lines"]:
        print(line, flush=True)
    return results[0]["lines"]


if __name__ == "__main__":
    main()
