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

5. The f32 forward at full width (the default ``compute_dtype``; same
   operating point, nothing cut): the arguments of ``gather_rows_auto`` are
   recorded at its call site in ``models.backbone`` on both check batches.
   K6a (windowed row gather) must equal its plain version exactly, for f32
   and for a bf16 copy of the rows; K6b (its backward, the row scatter-add)
   runs on a seeded cotangent of the recorded shapes, twice with equal bits
   (it uses no atomics), within 1e-5 of the output's scale of the plain
   ``index_add_`` (whose atomic sums vary from run to run; 1e-2 for a bf16
   cotangent, one rounding of the output).  The level-0 layer's input
   gradient through the kernels must agree with the same through the plain
   versions within 1e-4 of its scale.  Launch counters are zeroed, the f32
   forward runs on several batches and K1 and K6a must have launched; the
   logits must agree with the port's CPU run within 1e-4, valid slots equal.
6. Head training at full width through ``make_train_fns``: the first step's
   loss and head gradients against the same step on the CPU (dropout off;
   f32 within 1e-3 of each gradient's scale, bf16 loss within 0.1 per valid
   box, what the 0.05 logit band allows a summed cross entropy), 5 steps in
   box, what the 0.05 logit band allows a summed cross entropy), 3 steps on
   one batch with dropout off whose loss must fall, then 5 steps in f32 and
   5 in bf16 with dropout from a seeded CUDA generator and timed steps
   counted as ``bench.py`` counts its training figure.  Every loss must be
   finite, every head parameter must have changed and every DAGR parameter
   and buffer must be bit-identical.  Then evaluation (``eval_step`` ->
   ``collect_predictions`` -> the metric functions) on a few batches, and a
   checkpoint saved and loaded back on the card.

Each kernel's record also holds ``bound_ms``, the least time the card could
take for the same work: the larger of its bytes (every input read once,
every output written once; for K6b only the unmasked edge rows) over 3.35
TB/s and its operations on these inputs over the peak rate of their type
(989 TFLOP/s bf16, 67 TFLOP/s f32 and integer), and ``library_ms``, the time
of the one PyTorch call that computes the same function where there is one.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

OP_POINT = dict(batch_size=6, use_image=True, compute_dtype="bfloat16",
                event_buckets=(16384,))
BOXES_PER_ITEM = 6
KERNEL_TOL = 2e-2     # of the output's max |value|, bf16 outputs
LOGIT_TOL = 0.05      # absolute, GPU (kernels) vs CPU (non-fused), bf16
RUNS = 5
F32_LOGIT_TOL = 1e-4  # absolute, GPU (kernels) vs CPU, f32
SCATTER_TOL = 1e-5    # of the output's scale, f32 sums in another order
SCATTER_BF16_TOL = 1e-2   # one bf16 rounding of the output
LAYER_GRAD_TOL = 1e-4     # of the gradient's scale
HEAD_GRAD_TOL = 1e-3      # of each gradient's scale, GPU vs CPU, f32
BF16_LOSS_BAND = 2 * LOGIT_TOL   # per valid box, summed cross entropy
TRAIN_STEPS = 5
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12    # tensor cores, dense
PEAK_F32 = 67e12      # outside the tensor cores (integer work counted here)

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


def tensor_bytes(obj):
    """Bytes of every tensor in a (nested) argument or result."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(tensor_bytes(v) for v in obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(tensor_bytes(v) for v in obj)
    return 0


def search_ops(a, kw, out):
    """K1: six integer operations (two offsets, four compares) for every
    candidate this data makes a destination examine: the valid events of
    its item at most delta_t before it, within the lookback."""
    pos, valid = a[0], a[1]
    n = 0
    for b in range(pos.shape[0]):
        t = pos[b, :, 2][valid[b]].contiguous()
        first = torch.searchsorted(t, t - kw["delta_t_us"])
        span = torch.arange(len(t), device=t.device) - first
        n += int(span.clamp(max=kw["lookback"]).sum())
    return 6 * n, PEAK_F32


def level0_ops(a, kw, out):
    """K2: per edge four bilinear taps of both blocks' contractions, per
    valid node the two root products and the skip product."""
    src, prep, w1, w2, node_mask = a[0], a[1], a[2], a[6], a[8]
    c, c1, c2 = src.shape[1], w1.shape[-1], w2.shape[-1]
    edges, nodes = int((prep.nbr >= 0).sum()), int(node_mask.sum())
    return 2 * (edges * 4 * (c * c1 + c1 * c2)
                + nodes * (c * c1 + c1 * c2 + c * c2)), PEAK_BF16


def shift_ops(a, kw, out):
    """K3: per edge four bilinear taps of the contraction, per valid node
    the root product and, on the second block, the skip product."""
    src, prep, weight = a[0], a[1], a[2]
    c, o = src.shape[1], weight.shape[-1]
    edges, nodes = int(prep.mq.sum()), int(prep.node_mask.sum())
    skip = kw.get("skip")
    cs = skip[0].shape[1] if skip is not None else 0
    return 2 * (edges * 4 * c * o + nodes * (c + cs) * o), PEAK_BF16


def upsample_ops(a, kw, out):
    """K4: three interpolations of three operations per output value."""
    return 9 * out.numel(), PEAK_F32


def bound(nbytes, ops, peak):
    """``(bound_ms, bound_by)``: the larger of bytes over the memory rate
    and operations over their peak rate."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


OPS = {"event_graph_search": search_ops, "spline_fused_level0": level0_ops,
       "spline_shift_pooled": shift_ops, "upsample_rows": upsample_ops}


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
        err, ms, plain_ms, nbytes, ops = 0.0, 0.0, 0.0, 0, 0
        for a, kw in op_calls[name]:
            got = cuda_fn(*a, **kw)
            err = max(err, compare(name, got, plain_fn(*a, **kw)))
            ms += median_ms(lambda: cuda_fn(*a, **kw))
            plain_ms += median_ms(lambda: plain_fn(*a, **kw))
            nbytes += tensor_bytes(a) + tensor_bytes(kw) + tensor_bytes(got)
            n_ops, peak = OPS[name](a, kw, got)
            ops += n_ops
        bound_ms, bound_by = bound(nbytes, ops, peak)
        dense_err = max(compare(name, cuda_fn(*a, **kw), plain_fn(*a, **kw))
                        for a, kw in dense_calls[name])
        shapes = [tuple(t.shape) for t in op_calls[name][0][0]
                  if isinstance(t, torch.Tensor)]
        log(f"{name}: {len(op_calls[name])} call(s) per forward, first input"
            f" shapes {shapes}; max abs err {err:.3g} (dense / under-filled"
            f" batch {dense_err:.3g}); kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms per forward; bound {bound_ms:.5f} ms by "
            f"{bound_by} ({nbytes} bytes, {ops} operations); no single "
            f"PyTorch call computes it")
        records.append(dict(name=name, route="cuda", source=src,
                            replaces=replaces,
                            max_abs_err=max(err, dense_err), ms=ms,
                            plain_ms=plain_ms, bound_ms=bound_ms,
                            bound_by=bound_by, library_ms=None))

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

    # ---- 5. the f32 forward: K6a, K6b and the level-0 gradient ----
    from eventad_tpu_torch.models import backbone as bb
    from eventad_tpu_torch.ops import gather_window as gw

    bc32 = bc._replace(compute_dtype="float32")
    log(f"f32 path: same operating point, compute_dtype float32, gather "
        f"lookback {bc32.gather_lookback}")

    def recorded_f32_forward(batch):
        """The f32 model_forward with the arguments of gather_rows_auto and
        of the level-0 apply_layer recorded at their call sites."""
        gathers, layers = [], []
        orig_gather, orig_layer = bb.gather_rows_auto, bb.apply_layer

        def rec_gather(*a, **kw):
            gathers.append((a, kw))
            return orig_gather(*a, **kw)

        def rec_layer(layer, g, **kw):
            if kw.get("grid") is None:
                layers.append((layer, g, kw))
            return orig_layer(layer, g, **kw)
        bb.gather_rows_auto, bb.apply_layer = rec_gather, rec_layer
        try:
            model_forward(model, batch, bc32, mc, gsc)
            torch.cuda.synchronize()
        finally:
            bb.gather_rows_auto, bb.apply_layer = orig_gather, orig_layer
        if len(gathers) != 2 or len(layers) != 1:
            raise AssertionError(f"f32 forward: {len(gathers)} gathers, "
                                 f"{len(layers)} level-0 layers recorded")
        return gathers, layers[0]

    op_g, op_layer = recorded_f32_forward(batches[0])
    dense_g, _ = recorded_f32_forward(dense)
    cot_gen = torch.Generator(device=dev).manual_seed(11)

    def check_gather(a, kw):
        src, nbr, mask = a
        for s in (src, src.to(torch.bfloat16)):
            got = gw.gather_window_rows_cuda(s, nbr, mask, **kw)
            if not torch.equal(got, gw.gather_window_rows_plain(s, nbr,
                                                                mask)):
                raise AssertionError(f"gather_window_rows ({s.dtype}): "
                                     f"kernel != plain version")

    def check_scatter(a, kw):
        """Max abs error of K6b on a seeded cotangent against index_add_;
        also twice the same bits, and a bf16 cotangent."""
        src, nbr, mask = a
        n_src, c = src.shape
        g = torch.randn(nbr.shape + (c,), generator=cot_gen, device=dev)
        got = gw.scatter_window_rows_cuda(g, nbr, mask, n_src, **kw)
        again = gw.scatter_window_rows_cuda(g, nbr, mask, n_src, **kw)
        if not torch.equal(got, again):
            raise AssertionError("scatter_window_rows: two runs differ")
        want = gw.scatter_window_rows_plain(g, nbr, mask, n_src)
        scale = want.abs().max().item() + 1e-6
        err = (got - want).abs().max().item()
        if not err <= SCATTER_TOL * scale:
            raise AssertionError(f"scatter_window_rows: max abs err {err} "
                                 f"> {SCATTER_TOL} x {scale}")
        g16 = g.to(torch.bfloat16)
        got16 = gw.scatter_window_rows_cuda(g16, nbr, mask, n_src, **kw)
        want16 = gw.scatter_window_rows_plain(g16, nbr, mask, n_src)
        err16 = (got16.float() - want16.float()).abs().max().item()
        if got16.dtype != torch.bfloat16 or not err16 <= SCATTER_BF16_TOL \
                * scale:
            raise AssertionError(f"scatter_window_rows (bf16): max abs err "
                                 f"{err16} > {SCATTER_BF16_TOL} x {scale}")
        # the kernel sums in ascending edge order, as a sequential index_add
        seq = gw.scatter_window_rows_plain(g.cpu(), nbr.cpu(), mask.cpu(),
                                           n_src)
        return err, bool(torch.equal(got.cpu(), seq)), g

    g_ms = g_plain = g_lib = s_ms = s_plain = s_lib = 0.0
    g_bytes = s_bytes = s_ops = 0
    s_err, s_seq = 0.0, True
    for a, kw in op_g:
        src, nbr, mask = a
        n_src, c = src.shape
        check_gather(a, kw)
        err, seq, g = check_scatter(a, kw)
        s_err, s_seq = max(s_err, err), s_seq and seq
        idx = torch.where(mask, nbr, 0).long()
        g_ms += median_ms(lambda: gw.gather_window_rows_cuda(*a, **kw))
        g_plain += median_ms(lambda: gw.gather_window_rows_plain(*a))
        g_lib += median_ms(lambda: src[idx])
        s_ms += median_ms(lambda: gw.scatter_window_rows_cuda(
            g, nbr, mask, n_src, **kw))
        s_plain += median_ms(lambda: gw.scatter_window_rows_plain(
            g, nbr, mask, n_src))
        flat_idx = idx.reshape(-1)
        gm = torch.where(mask[..., None], g, 0.0).reshape(-1, c)
        s_lib += median_ms(lambda: torch.zeros(
            (n_src, c), device=dev).index_add_(0, flat_idx, gm))
        edges = int(mask.sum())
        out_bytes = mask.numel() * c * src.element_size()
        g_bytes += tensor_bytes(a) + out_bytes
        # the scatter needs only the unmasked edge rows of the cotangent
        s_bytes += (tensor_bytes((nbr, mask)) + edges * c * g.element_size()
                    + n_src * c * src.element_size())
        s_ops += edges * c
        del g, gm
    for a, kw in dense_g:
        check_gather(a, kw)
        err, seq, _ = check_scatter(a, kw)
        s_err, s_seq = max(s_err, err), s_seq and seq
    g_bound, g_by = bound(g_bytes, 0, PEAK_F32)
    s_bound, s_by = bound(s_bytes, s_ops, PEAK_F32)
    shapes = [tuple(t.shape) for t in op_g[0][0]]
    log(f"gather_window_rows: 2 calls per f32 forward, first input shapes "
        f"{shapes}; equal to the plain version exactly (f32 and bf16, both "
        f"batches); kernel {g_ms:.4f} ms, plain {g_plain:.4f} ms, indexed "
        f"gather src[idx] {g_lib:.4f} ms per forward; bound {g_bound:.5f} "
        f"ms by {g_by} ({g_bytes} bytes)")
    log(f"scatter_window_rows: cotangents of the same shapes; max abs err "
        f"vs index_add_ {s_err:.3g} (tolerance {SCATTER_TOL} of scale); two "
        f"runs bit-identical; equal to the CPU's sequential index_add_ "
        f"exactly: {s_seq}; kernel {s_ms:.4f} ms, plain {s_plain:.4f} ms, "
        f"index_add_ {s_lib:.4f} ms for both; bound {s_bound:.5f} ms by "
        f"{s_by} ({s_bytes} bytes, {s_ops} additions)")

    # gradient of the level-0 layer's input, kernels against plain versions
    layer0, g0, layer_kw = op_layer
    proj = torch.randn((g0.x.shape[0], bc.channels[1]), generator=cot_gen,
                       device=dev)

    def layer_input_grad():
        x = g0.x.detach().clone().requires_grad_(True)
        out, _ = bb.apply_layer(layer0, g0._replace(x=x), **layer_kw)
        (out.x * proj).sum().backward()
        return x.grad

    gw.gather_window_rows_cuda.launches = 0
    gw.scatter_window_rows_cuda.launches = 0
    grad_kernel = layer_input_grad()
    grad_launches = (gw.gather_window_rows_cuda.launches,
                     gw.scatter_window_rows_cuda.launches)
    if grad_launches != (2, 2):
        raise AssertionError(f"level-0 gradient: (gather, scatter) launches "
                             f"{grad_launches}, expected (2, 2)")
    kernel_route = bb.gather_rows_auto
    bb.gather_rows_auto = lambda s, n, m, lookback: \
        gw.gather_window_rows_plain(s, n, m)
    try:
        grad_plain = layer_input_grad()
    finally:
        bb.gather_rows_auto = kernel_route
    if gw.scatter_window_rows_cuda.launches != 2:
        raise AssertionError("the plain route launched a kernel")
    gscale = grad_plain.abs().max().item() + 1e-12
    gerr = (grad_kernel - grad_plain).abs().max().item()
    log(f"level-0 layer input gradient {tuple(grad_kernel.shape)}: kernels "
        f"vs plain versions max abs diff {gerr:.3g} (scale {gscale:.3g}, "
        f"tolerance {LAYER_GRAD_TOL} of scale); launches (K6a, K6b) "
        f"{grad_launches}")
    if not gerr <= LAYER_GRAD_TOL * gscale:
        raise AssertionError(f"level-0 gradient differs by {gerr}")
    del grad_kernel, grad_plain, proj

    # the f32 main path, counters zeroed just before
    build_graph_cuda = counters["event_graph_search"]
    build_graph_cuda.launches = 0
    gw.gather_window_rows_cuda.launches = 0
    ts32, outs32 = [], []
    for i in range(RUNS):
        t0 = time.perf_counter()
        o = model_forward(model, batches[i], bc32, mc, gsc)
        torch.cuda.synchronize()
        ts32.append(time.perf_counter() - t0)
        outs32.append(o)
    f32_launches = dict(event_graph_search=build_graph_cuda.launches,
                        gather_window_rows=gw.gather_window_rows_cuda
                        .launches)
    log(f"launches over {RUNS} f32 forwards: {f32_launches}")
    if f32_launches != dict(event_graph_search=RUNS,
                            gather_window_rows=2 * RUNS):
        raise AssertionError(f"f32 forward launches {f32_launches}")
    med32 = sorted(ts32)[len(ts32) // 2]
    log(f"f32 forward times (s, sync per batch): {ts32}")
    log(f"f32 sync bboxes/s: {n_boxes / med32} (median {med32 * 1e3:.3f} ms "
        f"per batch, tf32 off)")
    for i in (0, 1):
        t0 = time.perf_counter()
        ref = model_forward(cpu_model, cpu_batches[i], bc32, mc, gsc)
        got = outs32[i]
        if not torch.equal(ref.valid, got.valid.cpu()):
            raise AssertionError(f"f32 batch {i}: valid slots differ")
        v = ref.valid
        d = (ref.logits[v] - got.logits.cpu()[v]).abs().max().item()
        log(f"f32 batch {i}: GPU vs CPU logits max abs diff {d:.3g} over "
            f"{int(v.sum())} valid slots (tolerance {F32_LOGIT_TOL}); CPU "
            f"forward {time.perf_counter() - t0:.1f} s")
        if not (d < F32_LOGIT_TOL and bool(torch.isfinite(got.logits)
                                           .all())):
            raise AssertionError(f"f32 GPU vs CPU logits differ by {d}")
    gather_src = "eventad_tpu_torch/csrc/gather_window.cu"
    records.append(dict(
        name="gather_window_rows", route="cuda", source=gather_src,
        replaces="eventad_tpu/ops/gather_window.py:41",
        launches=f32_launches["gather_window_rows"], max_abs_err=0.0,
        ms=g_ms, plain_ms=g_plain, bound_ms=g_bound, bound_by=g_by,
        library_ms=g_lib))
    records.append(dict(
        name="scatter_window_rows", route="cuda", source=gather_src,
        replaces="eventad_tpu/ops/gather_window.py:169",
        launches=grad_launches[1], max_abs_err=s_err, ms=s_ms,
        plain_ms=s_plain, bound_ms=s_bound, bound_by=s_by,
        library_ms=s_lib))

    # ---- 6. head training at full width ----
    from eventad_tpu_torch.data.synthetic import synthetic_loader
    from eventad_tpu_torch.parallel.train_step import (make_optimizer,
                                                       make_train_fns)
    from eventad_tpu_torch.utils import checkpoint as ckpt
    from eventad_tpu_torch.utils.evaluation import (
        calculate_bbox_metrics, calculate_frame_metrics,
        calculate_response_metrics, calculate_tta_metrics)
    from eventad_tpu_torch.utils.predict import collect_predictions

    tmodel, _, _ = init_model(cfg, torch.Generator().manual_seed(0), dev)
    frozen = {k: v.clone() for k, v in tmodel.dagr.state_dict().items()}
    head0 = {k: v.clone() for k, v in tmodel.head.state_dict().items()}
    optimizer = make_optimizer(tmodel.head.parameters(), cfg.learning_rate,
                               cfg.weight_decay, cfg.grad_clip)
    fns = {"float32": make_train_fns(tmodel, bc32, mc, gsc, optimizer),
           "bfloat16": make_train_fns(tmodel, bc, mc, gsc, optimizer)}

    def first_step(m, batch, bcx):
        """Loss and head gradients of one step, dropout off, no update."""
        for p in m.head.parameters():
            p.grad = None
        out = model_forward(m, batch, bcx, mc, gsc, training=True)
        out.loss.backward()
        return (float(out.loss.detach()), int(out.n_valid),
                {k: p.grad.detach().cpu()
                 for k, p in m.head.named_parameters()})

    for dtype, bcx in (("float32", bc32), ("bfloat16", bc)):
        loss_g, nv, grads_g = first_step(tmodel, batches[0], bcx)
        loss_c, nv_c, grads_c = first_step(cpu_model, cpu_batches[0], bcx)
        log(f"first step ({dtype}, dropout off): loss GPU {loss_g:.6f} CPU "
            f"{loss_c:.6f} over {nv} valid boxes")
        if nv != nv_c:
            raise AssertionError(f"{dtype}: valid boxes {nv} vs {nv_c}")
        if dtype == "float32":
            worst = max((grads_g[k] - grads_c[k]).abs().max().item()
                        / (grads_c[k].abs().max().item() + 1e-12)
                        for k in grads_c)
            log(f"first step (float32): worst head-gradient difference "
                f"{worst:.3g} of its scale (tolerance {HEAD_GRAD_TOL})")
            if not (abs(loss_g - loss_c) <= HEAD_GRAD_TOL * abs(loss_c)
                    and worst <= HEAD_GRAD_TOL):
                raise AssertionError("f32 first step differs from the CPU")
        elif not abs(loss_g - loss_c) <= BF16_LOSS_BAND * nv:
            raise AssertionError("bf16 first-step loss differs from the CPU")
    for p in cpu_model.head.parameters():
        p.grad = None

    drop_gen = torch.Generator(device=dev).manual_seed(1)
    all_counters = dict(counters,
                        gather_window_rows=gw.gather_window_rows_cuda)

    def run_steps(dtype, step_batches, generator):
        losses = []
        for b in step_batches:
            m = fns[dtype].train_step(b, generator)
            loss = float(m["loss"])
            if not (m["finite"] and loss == loss and abs(loss) != float(
                    "inf")):
                raise AssertionError(f"{dtype} train step: non-finite loss")
            losses.append(loss / max(int(m["n_valid"]), 1))
        return losses

    # from the fresh optimizer state, before the noisy steps below
    losses = run_steps("float32", [batches[1]] * 3, None)
    log(f"3 train steps on one batch (f32, dropout off): loss per valid box "
        f"{losses}")
    if not losses[2] < losses[1] < losses[0]:
        raise AssertionError(f"the repeated-batch loss does not fall: "
                             f"{losses}")
    for dtype, expect in (
            ("float32", dict(event_graph_search=TRAIN_STEPS,
                             gather_window_rows=2 * TRAIN_STEPS)),
            ("bfloat16", dict(event_graph_search=TRAIN_STEPS,
                              spline_fused_level0=2 * TRAIN_STEPS,
                              spline_shift_pooled=8 * TRAIN_STEPS,
                              upsample_rows=2 * TRAIN_STEPS))):
        for fn in all_counters.values():
            fn.launches = 0
        losses = run_steps(dtype, batches[:TRAIN_STEPS], drop_gen)
        seen = {n: fn.launches for n, fn in all_counters.items()
                if fn.launches}
        log(f"{TRAIN_STEPS} train steps ({dtype}, dropout on): loss per "
            f"valid box {losses}; launches {seen}")
        if seen != expect:
            raise AssertionError(f"{dtype} train steps launched {seen}, "
                                 f"expected {expect}")
        # the training figure: 2 warm-up steps, then 10 on one batch
        run_steps(dtype, [batches[0]] * 2, drop_gen)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_steps(dtype, [batches[0]] * 10, drop_gen)
        torch.cuda.synchronize()
        dt_tr = time.perf_counter() - t0
        log(f"train_items_per_sec ({dtype}): {cfg.batch_size * 10 / dt_tr} "
            f"train_ms_per_batch: {dt_tr / 10 * 1e3} on {smi}")

    for k, v in tmodel.dagr.state_dict().items():
        if not torch.equal(v, frozen[k]):
            raise AssertionError(f"frozen DAGR tensor changed: {k}")
    for k, v in tmodel.head.state_dict().items():
        if torch.equal(v, head0[k]):
            raise AssertionError(f"head parameter did not change: {k}")
    log(f"after training: {len(frozen)} DAGR tensors bit-identical, "
        f"{len(head0)} head parameters changed")

    loader = synthetic_loader(cfg, 4, seed=100, boxes_per_item=BOXES_PER_ITEM)

    def forward(batch):
        logits, valid, labels, _, _ = fns["float32"].eval_step(batch)
        return (logits.cpu().numpy(), valid.cpu().numpy(),
                labels.cpu().numpy())
    results = collect_predictions(forward, loader, threshold=cfg.threshold)
    bbox = calculate_bbox_metrics(results["all_labels"],
                                  results["all_scores"])
    frame = calculate_frame_metrics(results["frame_data"])
    tta = calculate_tta_metrics(results["video_predictions"],
                                results["video_first_anomaly"])
    resp = calculate_response_metrics(results["video_predictions"])
    log(f"evaluation over {results['valid_batch_count']} batches, "
        f"{len(results['all_scores'])} boxes (random DAGR weights): AUC "
        f"{bbox['auc']:.4f} AUC unadjusted {bbox['auc_unadjusted']:.4f} AP "
        f"{bbox['ap']:.4f} AUC-Frame {frame['auc_frame']:.4f} mTTA "
        f"{tta['mtta']} mRESPONSE {resp['mresponse']}")
    for key in ("auc", "auc_unadjusted"):
        if not 0.0 <= bbox[key] <= 1.0:
            raise AssertionError(f"{key} = {bbox[key]}")
    if not -0.1 <= bbox["ap"] <= 0.9:      # the reference's flat -0.1
        raise AssertionError(f"ap = {bbox['ap']}")

    with tempfile.TemporaryDirectory() as tmp:
        ckpt.save_checkpoint(tmp, tmodel, optimizer, 0, bbox["auc"],
                             bbox["ap"], True, False)
        other, _, _ = init_model(cfg, torch.Generator().manual_seed(7), dev)
        extra = ckpt.load_checkpoint(
            ckpt.find_best_checkpoint("", "", str(
                Path(tmp) / "best_auc_model.pt")), other)
    want = tmodel.state_dict()
    for k, v in other.state_dict().items():
        if not (v.is_cuda and torch.equal(v, want[k])):
            raise AssertionError(f"checkpoint round trip: {k} differs")
    log(f"checkpoint saved and loaded back on the card: {len(want)} tensors "
        f"equal, extra {extra}")

    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
