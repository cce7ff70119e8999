#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``eventad_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed on its own lines; any failure raises and the script
exits non-zero without printing a result:

1. CUDA check (no fallback to the CPU) and the card's name and power limit.
2. Build of the CUDA kernels from ``eventad_tpu_torch/csrc`` (nvcc,
   sm_90a), with the build seconds.
3. The batched scoring forward at the reference operating point (batch 6,
   360x240, 16 384 events per item, ResNet-50 image branch, bf16 frozen DAGR
   features, f32 head, random weights from a seeded generator) runs once
   while the arguments of every kernel wrapper are recorded, and once more
   on a check batch with dense graphs and an under-filled item.  Each kernel
   is then held against its plain PyTorch version on those very arguments:
   K1 (neighbour search) exactly, K2-K4 within 2e-2 of the output's scale
   (one bf16 rounding of the outputs and of the block-1 rows they read),
   with median times (CUDA events) at the operating point.
4. Launch counters are zeroed, the forward runs on several batches (new
   seeds), and the counters are read: every kernel must have launched.
   Logits must be finite and ``[6, 31, 2]``, and agree with the same
   weights and batch run through the port on the CPU (bf16, the non-fused
   formulation) within 0.05 absolute, the band of
   ``tests/test_bf16_path.py``; the valid slots must be equal.  Sync
   bboxes/s is counted as ``bench.py`` counts it (both frames' boxes, one
   synchronised batch at a time, median batch time).

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

OP_POINT = dict(batch_size=6, use_image=True, compute_dtype="bfloat16",
                event_buckets=(16384,))
BOXES_PER_ITEM = 6
KERNEL_TOL = 2e-2     # of the output's max |value|, bf16 outputs
LOGIT_TOL = 0.05      # absolute, GPU (kernels) vs CPU (non-fused), bf16
RUNS = 5

KERNELS = [
    # name, ops module, kernel wrapper, plain version, the main path's call
    # site (module, attribute), source, replaced TPU kernel
    ("event_graph_search", "event_graph", "build_graph_cuda", "build_graph",
     ("models.dagr", "build_graph_auto"),
     "eventad_tpu_torch/csrc/event_graph_search.cu",
     "eventad_tpu/ops/event_graph_pallas.py:61"),
    ("spline_fused_level0", "spline_fused", "fused_two_block_cuda",
     "fused_two_block_plain", ("models.backbone", "fused_two_block"),
     "eventad_tpu_torch/csrc/spline_fused.cu",
     "eventad_tpu/ops/spline_fused.py:294"),
    ("spline_shift_pooled", "spline_shift", "shift_spline_conv_cuda",
     "shift_spline_conv_plain", ("models.backbone", "shift_spline_conv"),
     "eventad_tpu_torch/csrc/spline_shift.cu",
     "eventad_tpu/ops/spline_shift.py:136"),
    ("upsample_rows", "upsample_flat", "upsample_rows_cuda",
     "upsample_rows_plain", ("models.backbone", "upsample_rows"),
     "eventad_tpu_torch/csrc/upsample_rows.cu",
     "eventad_tpu/ops/upsample_flat.py:54"),
]


def log(msg):
    print(f"chip_smoke: {msg}", flush=True)


def median_ms(fn, reps=10, warmup=2):
    for _ in range(warmup):
        fn()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        ts.append(a.elapsed_time(b))
    ts.sort()
    return ts[len(ts) // 2]


def compare(name, got, want):
    """Max abs error of the kernel's outputs against the plain version's;
    raises if outside the stated tolerance."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs "
                                 f"{w.shape}/{w.dtype}")
        if name == "event_graph_search":       # integer outputs: exact
            if not torch.equal(g, w):
                raise AssertionError(f"{name}: kernel != plain version")
            continue
        d = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item() + 1e-6
        if not d <= KERNEL_TOL * scale:
            raise AssertionError(f"{name}: max abs err {d} > "
                                 f"{KERNEL_TOL} x {scale}")
        err = max(err, d)
    return err


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this smoke run needs "
                         "a GPU and never falls back to the CPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import importlib

    from eventad_tpu_torch.config import Config
    from eventad_tpu_torch.data.synthetic import make_synthetic_batch
    from eventad_tpu_torch.models.dagr import (graph_static_config,
                                               init_model, model_forward)
    from eventad_tpu_torch.ops import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    log(f"device {torch.cuda.get_device_name(0)}, torch {torch.__version__}"
        f", CUDA {torch.version.cuda}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    kernels.library()
    log(f"kernels built in {kernels.library.build_seconds:.1f} s (nvcc), "
        f"loaded in {time.perf_counter() - t0:.1f} s: "
        f"{kernels.library_path().name}")
    nvcc_log = kernels.BUILD_DIR / "nvcc.log"
    if nvcc_log.exists():
        for line in nvcc_log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("ptxas " + line.split("info    :")[-1].strip())

    # ---- 3. one forward with the kernel wrappers' arguments recorded ----
    cfg = Config(**OP_POINT)
    gsc = graph_static_config(cfg)
    model, bc, mc = init_model(cfg, torch.Generator().manual_seed(0), dev)
    cpu_batches = [make_synthetic_batch(cfg, seed=s,
                                        boxes_per_item=BOXES_PER_ITEM)
                   for s in range(RUNS)]
    batches = [b.to(dev) for b in cpu_batches]
    log(f"operating point: batch {cfg.batch_size}, {cfg.model_width}x"
        f"{cfg.model_height}, {batches[0].pos.shape[1]} events/item, "
        f"{cfg.img_net}, {cfg.compute_dtype} features")

    mods = {k[1]: importlib.import_module(f"eventad_tpu_torch.ops.{k[1]}")
            for k in KERNELS}

    def recorded_forward(batch):
        """model_forward with every kernel wrapper's arguments recorded at
        its call site on the main path."""
        calls = {k[0]: [] for k in KERNELS}
        originals = []
        for name, _, _, _, (hmod, attr), _, _ in KERNELS:
            m = importlib.import_module(f"eventad_tpu_torch.{hmod}")
            orig = getattr(m, attr)
            originals.append((m, attr, orig))

            def rec(*a, _orig=orig, _name=name, **kw):
                calls[_name].append((a, kw))
                return _orig(*a, **kw)
            setattr(m, attr, rec)
        try:
            model_forward(model, batch, bc, mc, gsc)
            torch.cuda.synchronize()
        finally:
            for m, attr, orig in originals:
                setattr(m, attr, orig)
        for name, found in calls.items():
            if not found:
                raise AssertionError(f"{name}: the main path never called it")
        return calls

    # a second check batch: dense graphs (timestamps squeezed 50x, so most
    # events get all 15 neighbours) and item 0 under-filled, its padding
    # tail at t = 0 as collate pads it
    b0 = cpu_batches[0]
    pos, valid, pol = b0.pos.clone(), b0.valid.clone(), b0.polarity.clone()
    pos[..., 2] //= 50
    tail = pos.shape[1] * 9 // 16
    pos[0, tail:] = 0
    valid[0, tail:] = False
    pol[0, tail:] = 0
    dense = b0._replace(pos=pos, valid=valid, polarity=pol).to(dev)
    op_calls = recorded_forward(batches[0])
    dense_calls = recorded_forward(dense)

    records = []
    for name, mod, cuda_name, plain_name, _, src, replaces in KERNELS:
        cuda_fn = getattr(mods[mod], cuda_name)
        plain_fn = getattr(mods[mod], plain_name)
        err, ms, plain_ms = 0.0, 0.0, 0.0
        for a, kw in op_calls[name]:
            err = max(err, compare(name, cuda_fn(*a, **kw),
                                   plain_fn(*a, **kw)))
            ms += median_ms(lambda: cuda_fn(*a, **kw))
            plain_ms += median_ms(lambda: plain_fn(*a, **kw))
        dense_err = max(compare(name, cuda_fn(*a, **kw), plain_fn(*a, **kw))
                        for a, kw in dense_calls[name])
        shapes = [tuple(t.shape) for t in op_calls[name][0][0]
                  if isinstance(t, torch.Tensor)]
        log(f"{name}: {len(op_calls[name])} call(s) per forward, first input"
            f" shapes {shapes}; max abs err {err:.3g} (dense / under-filled"
            f" batch {dense_err:.3g}); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms per forward")
        records.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces,
                            max_abs_err=max(err, dense_err), ms=ms,
                            plain_ms=plain_ms))

    def edges_per_event(calls):
        nbr = calls["spline_fused_level0"][0][0][1].nbr
        return float((nbr >= 0).sum()) / nbr.shape[0]
    log(f"level-0 edges per event (self edge excluded): operating point "
        f"{edges_per_event(op_calls):.3f}, dense batch "
        f"{edges_per_event(dense_calls):.3f}")

    # ---- 4. the main path, counters zeroed just before ----
    counters = {k[0]: getattr(mods[k[1]], k[2]) for k in KERNELS}
    for fn in counters.values():
        fn.launches = 0
    n_boxes = int(batches[0].box_present.sum())
    ts, outs = [], []
    for i in range(RUNS):
        t0 = time.perf_counter()
        o = model_forward(model, batches[i], bc, mc, gsc)
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
        outs.append(o)
    launches = {n: fn.launches for n, fn in counters.items()}
    for r in records:
        r["launches"] = launches[r["name"]]
        if r["launches"] <= 0:
            raise AssertionError(f"{r['name']}: no launch on the main path")
    log(f"launches over {RUNS} forwards: {launches}")
    ts_sorted = sorted(ts)
    med = ts_sorted[len(ts_sorted) // 2]
    log(f"forward times (s, sync per batch): {ts}")
    log(f"sync bboxes/s: {n_boxes / med} ({n_boxes} bboxes per batch, "
        f"median {med * 1e3:.3f} ms per batch, tf32 off)")

    for i, o in enumerate(outs):
        if tuple(o.logits.shape) != (cfg.batch_size, cfg.max_boxes + 1, 2):
            raise AssertionError(f"logits shape {tuple(o.logits.shape)}")
        if not bool(torch.isfinite(o.logits).all()):
            raise AssertionError(f"batch {i}: non-finite logits")
        if int(o.n_valid) <= 0:
            raise AssertionError(f"batch {i}: no valid slot")

    # CPU leg: same weights, same batches, the port on the CPU
    cpu_model, _, _ = init_model(cfg, torch.Generator().manual_seed(0),
                                 "cpu")
    for i in (0, 1):
        t0 = time.perf_counter()
        ref = model_forward(cpu_model, cpu_batches[i], bc, mc, gsc)
        got = outs[i]
        if not torch.equal(ref.valid, got.valid.cpu()):
            raise AssertionError(f"batch {i}: valid slots differ from CPU")
        v = ref.valid
        d = (ref.logits[v] - got.logits.cpu()[v]).abs().max().item()
        log(f"batch {i}: GPU vs CPU logits max abs diff {d:.3g} over "
            f"{int(v.sum())} valid slots (tolerance {LOGIT_TOL}); CPU "
            f"forward {time.perf_counter() - t0:.1f} s; loss GPU "
            f"{float(got.loss):.5f} CPU {float(ref.loss):.5f}")
        if not d < LOGIT_TOL:
            raise AssertionError(f"GPU vs CPU logits differ by {d}")

    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
