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
   (one bf16 rounding of the outputs and of the block-1 rows they read; K3
   also rounds each tap's ``z`` to bf16, as the TPU kernel does), with
   median times (CUDA events) at the operating point; K4 also within 2e-2
   of ``models.graph.upsample_lookup``, its plain version before the tap
   tables.  K1, K2, K3, K7 and K6a also run on shapes the path does not
   reach (``check_search_general``, ``check_level0_general``,
   ``check_shift_general``, ``check_bilinear_general``,
   ``check_gather_wide``: an output of 2^31 elements or more).
   K8 (graph pooling) runs on the forward's four poolings at the 16 384
   bucket and on those of a forward at the 32 768 one, each call as
   recorded (bf16, ``pos_src``, max, mean at level 4) and in three
   variants (through ``nbr`` with the temporal ordering; f32 features with
   the other aggregation and ``pos_nbr``; f32 through ``nbr``, temporal,
   ``pos_nbr``): a max pooling's features, ``nbr``, the masks, ``active``
   and the batch column equal to the plain formulation exactly, a mean's
   features within one rounding of their type of scale, the pooled ``t``
   within 1e-5 of scale, the pooled ``x``, ``y`` and ``pos_nbr`` equal but
   where a cell's f32 mean lies on a pixel boundary (there one pixel step
   apart, in at most 1 % of the active cells; counted and printed).
   A second forward must reuse K2's and K3's weight packs and K3's static
   tables; a trace of ``prepare_shift`` and the two blocks of every pooled
   level, one K1 call and one level-0 layer must show K3's eight launches,
   K1's one and K2's two, and no other device operation (no copy to the
   card); and a weight changed in place must reach K3's output.
4. Launch counters are zeroed, the forward runs on several batches (new
   seeds), and the counters are read: every kernel must have launched, K8
   eight times a forward (two a pooling).
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
   and for a bf16 copy of the rows; K6b (its backward, the row scatter-add,
   two launches a call) runs on seeded cotangents of the recorded shapes on
   both check batches, in f32 and in bf16, each twice with equal bits (it
   adds no value by an atomic), within 1e-5 of the output's scale of the
   plain ``index_add_`` (whose atomic sums vary from run to run; 1e-2 for a
   bf16 cotangent, one rounding of the output), and equal to the CPU's
   sequential ``index_add_``.  The level-0 layer's input gradient through
   the kernels must agree with the same through the plain versions within
   1e-4 of its scale.  Launch counters are zeroed, the f32
   forward runs on several batches and K1 and K6a must have launched; the
   logits must agree with the port's CPU run within 1e-4, valid slots equal.
6. Head training at full width through ``make_train_fns``: the first step's
   loss and head gradients against the same step on the CPU (dropout off;
   f32 within 1e-3 of each gradient's scale, bf16 loss within 0.1 per valid
   box, what the 0.05 logit band allows a summed cross entropy), 3 steps on
   one batch with dropout off whose loss must fall, then 5 steps in f32 and
   5 in bf16 with dropout from a seeded CUDA generator and timed steps
   counted as ``bench.py`` counts its training figure.  Every loss must be
   finite, every head parameter must have changed and every DAGR parameter
   and buffer must be bit-identical.  Then evaluation (``eval_step`` ->
   ``collect_predictions`` -> the metric functions) on a few batches, and a
   checkpoint saved and loaded back on the card.

7. The other kernel flavours of the bf16 scoring forward.  The arguments of
   ``fused_spline_conv`` (K5) are recorded from the ``base`` flavour
   (``fused_two_block`` and ``fused_shift`` off: 10 calls per forward, two
   for each of the five levels) and those of ``sample_bilinear`` (K7) from
   the ``bilinear`` flavour (its 2 level-0/1 calls) and from the default
   flavour (the pooled levels 2-4, 3 calls), on both check batches.  K5 must agree
   with its plain version within 2e-3 of the output's scale (f32 output; a
   ``z`` value that rounds to the other bf16 neighbour moves one product by
   2^-8), its rows without an edge exactly zero, both forwards must pass
   the same weight packs, and it runs on shapes the path does not reach
   (``check_fused_general``: C 1 to 512, O 4 to 512); each of its ten
   calls is timed alone.  K7 runs on the recorded maps in bf16 and in f32,
   with positions pushed outside the map among the inputs, within 1e-2 (one
   bf16 rounding of the output) and 1e-5 (f32 sums in another order) of the
   output's scale; at levels 2-4 also against ``sample_image_features``,
   the lookup K7 replaced there: within one bf16 step (2^-7) of scale of
   its f32 evaluation and no farther from it than its bf16 evaluation.
   Then, counters zeroed before each, the ``base`` forward
   must launch K5 ten times a forward and neither K2 nor K3, the ``bilinear``
   forward K7 five times (levels 0-1 and 2-4) and never K4, the default
   and ``base`` forwards K7 three times; both flavours' logits must lie within
   0.05 of the port's CPU run of phase 4.  The default and ``base``
   flavours run twice in mirrored order (default, base, bilinear, base,
   default), so that their batch times compare within one call.
8. Detection serving (``models.detector.detector_forward``, eval mode, bf16,
   batch 6, 16 384 events per item, the operating point of
   ``bench_detector``): a detector from seed 0 whose BN running statistics
   are first moved to one batch's statistics by a few batch-statistics
   passes in f32 (random weights on the initial statistics overflow the
   ``exp`` of the box decode), copied to the CPU.  In the default flavour
   and in ``base`` + ``bilinear``: the maps before decoding (``reg``,
   ``obj``, ``cls`` per scale) within 0.1 of the CPU run's, relative to
   each map's scale (at least 1; in f32, run once, within 1e-3),
   ``decoded [6, 175, 7]`` finite,
   detections of the fixed shape, the expected launches per forward (the
   default flavour K3 18 times: the pooled levels' 8 and the GNN head's
   10; K7 3 times, 5 in ``base`` + ``bilinear``; K9 once in both), and
   images/s with batch ms by
   ``bench_detector``'s protocol.
9. Streaming (``streaming/``) at the root ``bench_streaming.py``'s
   operating point: batch 1, the same width, a ring of 16 384 events,
   chunks of 512, the phase-3 weights, events of
   ``streaming.evaluate.SyntheticStream``.  The incremental stream (ring
   filled raw, image, refresh, 8 steps with boxes) in bf16 against the same
   stream through the port on the CPU: equal valid slots, logits within
   0.05.  In f32 on one window: the dense stream (``consistency_check``)
   and the incremental one (refresh, appends, one read) against the batch
   ``model_forward`` at batch 1, within 1e-4.  Launches, counters zeroed
   before each: one ``append`` K1 once, one ``read_scores`` K3 and K8
   eight times each and K7 three times, one dense bf16 step K1, K4, K2
   twice, K7 three times, K3 and K8 eight times; K8 at a read's batch-1 grids as in phase 3; K1 at
   an append's tail and at the refresh of a ring still filling (invalid
   rows first, t = 0) equal to its plain version, K3 at a read's
   batch-1 grids and K2 and K4 at the dense step's (one item of 16 384
   rows, one image map) within 2e-2 of scale, a second read passing the
   same packs and static tables, with times and bounds as in phase 3.
   The detection read-out (``make_incremental_detector`` from the phase-8
   detector, refresh and three appends) against ``detector_forward`` at
   batch 1 on the same window, in bf16 on two windows (stream seeds 0 and
   1) and in f32 on the first: the maps and ``decoded`` within 0.1 (bf16)
   and 1e-3 (f32) of each map's or column's scale, as in phase 8,
   detections of the fixed shape; a bf16 read launches K3 18 times (the
   pooled levels' 8, the GNN head's 10), K7 3 times, K8 8 times and K9
   once (an f32
   read K8 8 times and K9 once), the head's K3
   route lies within 0.03 of each map's scale of its plain spline convs on
   the same graphs, and no host-blocking call falls inside
   ``detect/gnn_head`` (``torch.cuda.set_sync_debug_mode``, under which
   a copy from pageable memory there raises), with either head.  Then the
   times (``latency_bench_incremental``, ``latency_bench``, the read-out) and
   the device's busy share from a ``torch.profiler`` trace of 10 steps in
   a fresh process (``tools.profile_step streaming``: late in this one a
   trace may lose device events), on a line with the card's name and
   power limit.  K1's, K3's and K8's records gain ``streaming_append`` /
   ``streaming_read``, K2's and K4's ``streaming_dense_step`` and K1-K4's
   ``streaming_dense_step_launches``.
   Then K9 (the detection post-process, ``ops.nms.postprocess_cuda``)
   against the plain ``yolox_head.postprocess_plain`` on the card, bit for
   bit on all four outputs and all 64 slots (``same_detections``), on the
   main path's recorded calls (the batch detector's B 6 of phase 8, the
   three reads' B 1) and on ``nms_cases``: tied scores, box pairs of IoU
   one f32 ulp below, at and above 0.65 (their masks also equal to the
   CPU's), inf w or h and NaN or inf scores, every score below the
   threshold, fewer than 64 survivors, 128 and 129 anchors, A 40 and 1,
   and A 1 024 with 32 classes.  Its record: the wrapper, its launch alone
   and the plain version at the stream's shape (and ``batch_*`` at B 6),
   its bound by bytes (inputs and outputs once; at these sizes the launch
   bounds it).
10. Detector training (``train_detector.make_detector_train_step``: the
   forward to the decoded outputs in training mode, no NMS, the simOTA
   loss, the backward through the backbone and the ResNet, the clipped
   AdamW on the YOLOX schedule, the EMA) at the same operating point, a
   detector from seed 0.  The first f32 step on the card against the same
   step on the CPU: every loss component within 1e-4 relative, every
   gradient leaf within 1e-3 of its scale (5e-2 behind a max-pooling near
   tie, where f32 rounding picks the entry the cotangent goes to), the
   running statistics within 1e-3; the first bf16 step's loss within 2 %
   of the CPU's.  One f32 step launches K1 once, K6a twice and K6b four
   times (two calls) and no other kernel; K6b at that step's cotangents
   equals ``index_add_`` within 1e-5 of scale, bit-identical twice, timed
   beside it and its bound (K6b's record takes these as its own figures,
   the phase-5 check's as ``check_*``).  Five steps a dtype on one batch
   from a fresh optimizer (warm-up of one step) must give finite, falling
   losses, five EMA updates, f32 master weights, EMA and statistics; the
   bf16 EMA weights are evaluated (mAP, not gated) with K1-K4's, K7's, K8's
   and K9's launches counted (K8 none in a training step: its gradient takes
   the plain formulation; K9 none: a step runs no NMS); step ms, items/s and peak memory per dtype, and the device's
   busy share from ``tools.profile_step detector_train`` in a fresh
   process per dtype.  Every record gains ``train_step_launches``.
11. The host data path feeding the card (``data/``): six sequences made in
   memory by the fixture's array generator (``data/fixtures.make_sequence``,
   frames rendered at model size, 6 boxes, ~16 000 events a window, the
   anomalous ones' windows after their TOA ~24 000) and cut into 48 Items
   by ``data/dataset.cut_item`` (``MemoryDataset``: no file, so no h5py,
   yaml or cv2, which the script checks it never imported).  The
   ``Loader`` serial, on its prefetch thread and in 4 spawned decode
   processes (which hide the card from themselves) must give the same 8
   batches bit for bit and count the same truncated events.  A loader
   batch's bf16 ``eval_step`` launches K1 once, K2 twice, K3 and K8 eight
   times each, K7 three times and K4 once (counters zeroed just before; records gain
   ``loader_batch_launches``), its logits within 0.05 of the port's CPU
   run with equal valid slots; three epochs, one a mode, launch that
   eightfold again.  Then ``collect_predictions``, the metric functions and
   ``measure_fps`` with the loader in the loop, and the times on a line
   with the card's name and power limit: ``collate`` ms p50 / p90 (its
   queue ranks alone, in the C++ of ``native/evio.cpp``, which must equal
   the numpy plain version on every item, and that version's time), per
   mode batches/s alone, the consumer's wait a batch and sync bboxes/s with
   the loader in the loop, and without it on the same batches staged on
   the card.  Last, the parity fixture's
   geometry (96x72, batch 2, the 4 096 bucket, lookback 512, seed 7, f32,
   no image): the head fine-tuned on the CPU by ``parity.
   _train_fixture_head`` (800 steps) is evaluated on the CPU and on the
   card (``parity.fixture_metrics``): AUC, AUC_unadjusted, AP and AUC-Frame
   within 1e-3, mTTA and mRESPONSE equal, the score digests within 1e-3
   relative; a head trained on the card must lower its loss and give
   finite metrics.
12. The parallel paths of ``parallel/`` on a world-size-1 NCCL group made
   through a ``FileStore`` (one card: NCCL refuses two ranks on one card),
   each against the same work without a group, from deep copies of the
   same weights: the data-parallel eval in bf16 on mesh "1" (logits within
   1e-6 of scale, valid slots and labels equal); the f32 head step with
   dropout on, under ``torch.use_deterministic_algorithms`` (loss within
   1e-6 relative, each head leaf's gradient and updated value within 1e-6
   of its scale, beside the plain step run twice; running statistics
   equal); the detector's f32 step on mesh "1x1" (losses within
   1e-5 relative); ``seq_sharded_features`` at D = 1 against the streaming
   ``refresh`` on one stream of the operating point's length (f32 within
   1e-5 of each level's scale, bf16 within 2e-2).  Each kernel's launches
   on the mesh must equal those without a group and include the path's
   kernels (K1 and K6a, the pooling plain under deterministic algorithms;
   K1-K4, K7 and K8; K1, K6a and K6b; K1, K6a and K8, with K3 and K7 in
   bf16); records gain ``dp_train_step_launches``, ``dp_eval_launches``,
   ``dp_detector_step_launches`` and ``seq_sp_launches``.  Then the f32
   head step's median time with and without the group, and a
   ``{"parallel_times": ...}`` JSON line.
13. The bf16 scoring forward of phase 4 (batch 0) captured in a CUDA graph
   (``utils/devtime.capture``: 3 warm-up forwards on a side stream, after
   which the cached tables and K2/K3 packs exist, then the capture): the
   launch counters read during the capture must be K1 1, K2 2, K3 8, K4 1,
   K7 3, K8 8 (records gain ``graph_capture_launches``); a replay's logits within
   0.05 of the port's CPU run of phase 4, valid slots equal; two replays
   no further apart than the largest spread of 10 eager forwards on the
   card (the ``index_add_`` atomics make f32 sums vary from run to run).
   Then ``python -m eventad_tpu_torch.bench`` and ``.bench_streaming`` in
   fresh processes (each takes its profiler trace early in its process):
   bench's four records, each a superset of the one before, with ``0 <
   mfu < 1``, no ``roofline_warning``, ``scan_device_ms_per_batch`` at most
   ``batch_ms`` and at least ``roofline_bound_ms``, and
   ``trace_device_ms_per_batch`` at most 1.10 times the scan time (the
   profiler lengthens each kernel);
   bench_streaming's ``device_step_ms``, ``device_append_ms``,
   ``device_step_trace_ms`` and ``dispatch_floor_ms`` finite and positive,
   the trace at most ``device_step_ms``.  Then a ``{"graph_times": ...}``
   JSON line.

Each kernel's record also holds ``bound_ms``, the least time the card could
take for the same work: the larger of its bytes (every input read once,
every output written once; for K6a and K6b ``nbr`` and the rows that
only the unmasked edges read, for K5 the source rows that an edge points
to and the weights of the taps that an edge touches) over 3.35
TB/s and its operations on these inputs over the peak rate of their type
(989 TFLOP/s bf16, 67 TFLOP/s f32 and integer), ``library_ms``, the time
of the one PyTorch call that computes the same function where there is one,
and ``launch_ms``, the kernels alone: the wrapper's launches, with the
operands as the wrapper prepared them, captured 20 times into a CUDA graph
whose replay is timed, summed over the path's calls (K1-K4's and K6a's
``dense_launch_ms`` likewise on the dense / under-filled check batch;
``library_launch_ms`` the library call by the same replay: ``F.grid_sample``
for K4 and K7, ``src[idx]`` for K6a, ``index_add_`` for K6b; K4's
``library_max_abs_diff`` its library call's difference from the plain
version, ``lookup_max_abs_err`` the kernel's from ``upsample_lookup``).
``ms`` is the wrapper, one call per pair of events, the host's share of a
call inside.

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
FLAVOUR_RUNS = 3
LAUNCH_REPS = 20      # launches between one pair of events (launch_ms)
FUSED_CONV_TOL = 2e-3     # of the output's scale: one z value rounded to
                          # the other bf16 neighbour moves a product by 2^-8
BILINEAR_TOL = {torch.float32: 1e-5,    # f32 sums in another order
                torch.bfloat16: 1e-2}   # one bf16 rounding of the output
# detector maps before decoding, of each map's scale (at least 1), against
# the port's CPU run.  bf16: the card's fused kernels and the CPU's non-fused
# formulation round at different points through five backbone layers and
# three head convs at random weights (the reference's own bf16 bounds for
# the detector, tests/test_detector.py:75-79, are wider: 0.3 absolute on the
# sigmoided outputs).  f32: sums in another order.
MAP_TOL = 0.1
F32_MAP_TOL = 1e-3
# the GNN head's K3 route against its plain spline convs on one read's
# graphs, of each map's scale: bf16 roundings at other points through three
# convs (tests/test_torch_detect_head_shift.py holds 0.02 on the CPU)
HEAD_TOL = 0.03
CALIBRATION_PASSES = 10
BASE = dict(fused_two_block=False, fused_shift=False)
BILINEAR = dict(bilinear_kernel=True)
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
     "fused_two_block_plain", ("ops.spline_fused", "fused_two_block"),
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
    ("pool_graph", "pooling", "pool_graph_cuda", "pool_graph_plain",
     ("models.backbone", "pool_graph"),
     "eventad_tpu_torch/csrc/pool_graph.cu",
     "none: XLA lowers eventad_tpu/ops/pooling.py:pool_graph"),
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


def graph_ms(enqueue, reps=LAUNCH_REPS):
    """Milliseconds of the card for one ``enqueue()``: ``reps`` of them are
    captured into one CUDA graph, which is replayed once to warm up and
    then timed, one replay between a pair of CUDA events.  The card runs
    the graph's kernels back to back, so the host's launch rate (one launch
    every ~0.013 ms from Python) does not enter; what is left besides the
    kernels is the start of one replay, spread over ``reps``.  The capture
    is begun by hand: ``torch.cuda.graph`` would first empty the
    allocator's cache and with it free memory that recorded launches still
    point to."""
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            for _ in range(reps):
                enqueue()
        finally:
            graph.capture_end()
    torch.cuda.synchronize()
    graph.replay()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def launch_ms(mod, fn):
    """Milliseconds of the kernels alone for one call of the wrapper ``fn``
    of ops module ``mod``: the C entries the wrapper calls are recorded with
    their arguments (``mod.launch``) and replayed through :func:`graph_ms`,
    so no operand is prepared and no launch is made inside the clock.
    The wrapper's temporaries are freed when it returns, but nothing
    allocates on the card before the replay ends, so the recorded pointers
    still hold what the wrapper put there."""
    recorded, orig = [], mod.launch

    def rec(name, *args):
        recorded.append((name, args))
        return orig(name, *args)
    mod.launch = rec
    try:
        out = fn()
    finally:
        mod.launch = orig
    if not recorded:
        raise AssertionError("launch_ms: the wrapper launched no kernel")

    def replay():
        for name, args in recorded:
            orig(name, *args)
    ms = graph_ms(replay)
    del out
    return ms


def check_bilinear_general(dev):
    """K7 on shapes the main path does not reach: C of 1, 3, 20 and 64 (one
    value, 2, 4 and 8 channels a thread), an N that no group size divides,
    f32 and bf16, dense outputs and ``out=`` column ranges of a wider table
    at aligned and unaligned offsets.  Returns the worst error relative to
    its tolerance and the number of cases."""
    from eventad_tpu_torch.ops import bilinear_sample as bsm
    gen = torch.Generator(device=dev).manual_seed(21)
    n, b, hp, wp, full_w, full_h = 997, 3, 9, 13, 104, 72
    worst, cases = 0.0, 0
    pos = torch.rand((n, 3), generator=gen, device=dev) * 1.2 - 0.1
    batch = torch.randint(0, b, (n,), generator=gen, device=dev,
                          dtype=torch.int32)
    mask = torch.rand((n,), generator=gen, device=dev) > 0.15
    kw = dict(full_width=full_w, full_height=full_h, batch=batch)
    for c in (1, 3, 20, 64):
        for dtype in (torch.float32, torch.bfloat16):
            feat = torch.randn((b, hp, wp, c), generator=gen,
                               device=dev).to(dtype)
            want = bsm.sample_bilinear_plain(feat, pos, mask, **kw)
            scale = want.float().abs().max().item() + 1e-6
            table = torch.full((n, c + 19), 7.0, dtype=dtype, device=dev)
            outs = [bsm.sample_bilinear_cuda(feat, pos, mask, **kw)]
            for off in (8, 3):
                table.fill_(7.0)
                view = table[:, off:off + c]
                got = bsm.sample_bilinear_cuda(feat, pos, mask, out=view,
                                               **kw)
                if got.data_ptr() != view.data_ptr() \
                        or not bool((table[:, :off] == 7).all()) \
                        or not bool((table[:, off + c:] == 7).all()):
                    raise AssertionError(
                        f"sample_bilinear out= (C {c}, {dtype}, offset "
                        f"{off}): wrote outside its column range")
                outs.append(view.clone())
            for got in outs:
                if not bool((got[~mask] == 0).all()):
                    raise AssertionError("sample_bilinear: a masked row is "
                                         "not zero")
                err = (got.float() - want.float()).abs().max().item()
                if not err <= BILINEAR_TOL[dtype] * scale:
                    raise AssertionError(
                        f"sample_bilinear (C {c}, {dtype}): max abs err "
                        f"{err} > {BILINEAR_TOL[dtype]} x {scale}")
                worst = max(worst, err / scale / BILINEAR_TOL[dtype])
                cases += 1
    return worst, cases


# K1 on geometries the main path does not reach: (name, items, events per
# item, width, height, radius, max_neighbors, lookback, change)
SEARCH_CASES = [
    ("k_other 1, N 5000 (no multiple of the tile)", 2, 5000, 360, 240, 4, 2,
     1024, None),
    ("k_other 8, dense times", 2, 4096, 360, 240, 4, 9, 1024, "dense"),
    ("k_other 15, radius 100: 64-bit keys", 2, 3000, 360, 240, 100, 16, 1024,
     None),
    ("configs/dota.yaml: 320x180, lookback 2048", 2, 32768, 320, 180, 4, 16,
     2048, None),
    ("an unsorted item", 2, 4096, 360, 240, 4, 16, 1024, "unsorted"),
    ("an invalid event between two valid ones whose times fall", 2, 4096,
     360, 240, 4, 16, 1024, "interior_invalid"),
    ("an under-filled item, t = 0 tail", 2, 4097, 360, 240, 4, 16, 1024,
     "tail"),
]


def check_search_general(dev):
    """K1 on the cases of ``SEARCH_CASES``, events from a seeded generator
    over 1 s with delta_t 10 ms and Q 128: kernel equal to the plain
    version exactly.  Returns the number of cases."""
    from eventad_tpu_torch.ops import event_graph as eg
    gen = torch.Generator(device=dev).manual_seed(41)
    for name, b, n, w, h, radius, k, lookback, change in SEARCH_CASES:
        pos = torch.stack([
            torch.randint(0, w, (b, n), generator=gen, device=dev),
            torch.randint(0, h, (b, n), generator=gen, device=dev),
            torch.randint(0, 1_000_000, (b, n), generator=gen,
                          device=dev).sort(1).values], -1).to(torch.int32)
        valid = torch.ones((b, n), dtype=torch.bool, device=dev)
        if change == "dense":
            pos[..., 2] //= 50
        elif change == "unsorted":
            pos[0] = pos[0, torch.randperm(n, generator=gen, device=dev)]
        elif change == "interior_invalid":
            for at in (300, 2000, 2001):
                valid[0, at] = False
                pos[0, at + 1, 2] = pos[0, at - 1, 2] - 30_000
        elif change == "tail":
            pos[0, n // 3:] = 0
            valid[0, n // 3:] = False
        ranks = torch.stack([eg.queue_rank(pos[i, :, 1] * 2**15 + pos[i, :, 0],
                                           valid[i]) for i in range(b)])
        kw = dict(radius=radius, delta_t_us=10_000, max_neighbors=k,
                  max_queue_size=128, lookback=lookback)
        wide = eg.search_key_bits(radius, 128, min(lookback, n))[1] > 32
        if wide != (radius == 100):
            raise AssertionError(f"K1 ({name}): 64-bit keys {wide}")
        got = eg.build_graph_cuda(pos, valid, ranks, **kw)
        want = eg.build_graph(pos, valid, ranks, **kw)
        torch.cuda.synchronize()
        for g, wt, what in zip(got, want, ("nbr", "mask", "doff")):
            if g.dtype != wt.dtype or not torch.equal(g, wt):
                raise AssertionError(f"event_graph_search ({name}): {what} "
                                     f"!= plain version")
        if not bool(want[1][..., 1:].any()):
            raise AssertionError(f"K1 ({name}): no edge at all")
    return len(SEARCH_CASES)


# K2 on shapes the main path does not reach: (C, O1, O2, activation, taps
# (the sub-rectangle's (x, y) ranges of the 5 x 5 kernel), the centre tap
# folded, share of slots that hold an edge).  Cases 7 and 8 reach the
# widest tile (O 40 to 64) and C above 32 with the weights in shared
# memory; the last five take widths the kernel reaches by padding O to 8,
# column groups and weights in device memory: base_width 0.125 (level-0 C
# 7, O 4), O 12 and an odd O, base_width 2.0 (C 67, O 64 with 15 taps:
# 180 KB of weights), O 136 and 256, and C and Cs 256 (fewer warps a block)
FULL, SUB, SUB3 = ((0, 4), (0, 4)), ((1, 3), (0, 4)), ((1, 3), (1, 3))
LEVEL0_CASES = [
    (1, 8, 8, "relu", SUB, True, 0.15),
    (19, 16, 16, "elu", SUB, True, 0.85),
    (33, 32, 32, "hardtanh", FULL, False, 0.3),
    (19, 32, 8, "silu", FULL, True, 0.5),
    (33, 8, 16, None, SUB, False, 1.0),
    (1, 16, 32, "relu", FULL, True, 0.0),          # no edge at all
    (64, 64, 40, "elu", SUB3, True, 0.5),
    (40, 40, 64, "relu", SUB, False, 0.3),
    (7, 4, 4, "relu", SUB, True, 0.15),            # base_width 0.125
    (19, 12, 13, "elu", FULL, True, 0.5),          # O 12, an odd O
    (67, 64, 64, "relu", SUB, True, 0.3),          # base_width 2.0
    (40, 136, 256, "silu", SUB, True, 0.4),        # column groups
    (256, 256, 12, "hardtanh", SUB, True, 0.3),    # C and Cs 256
]


def check_level0_general(dev):
    """K2 on the shapes of ``LEVEL0_CASES``: 997 rows (the last 16-row
    tile holds 5), 15 slots, neighbours up to 64 rows back, the first 70
    rows without an edge (whole tiles), inputs from a seeded generator;
    block 1 runs without and block 2 with the skip.  ``h`` and the output
    against the plain version from the same packs within ``KERNEL_TOL`` of
    scale.  Returns the worst error of scale and the number of cases."""
    from eventad_tpu_torch.ops import spline_fused as sfm
    gen = torch.Generator(device=dev).manual_seed(51)
    bf, ks, n, k = torch.bfloat16, 5, 997, 15
    worst = 0.0

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    for c, o1, o2, act, ranges, fold, share in LEVEL0_CASES:
        rows = torch.arange(n, device=dev)[:, None]
        back = torch.randint(1, 65, (n, k), generator=gen, device=dev)
        edges = (torch.rand((n, k), generator=gen, device=dev) < share) \
            & (rows - back >= 0)
        edges[:70] = False
        u = torch.rand((n, k, 2), generator=gen, device=dev) * (ks - 1)
        prep = sfm.prepare_fused((rows - back).to(torch.int32), edges, u)
        nodes = torch.rand((n,), generator=gen, device=dev) > 0.1
        src = rand(n, c).to(bf)
        kw = dict(kernel_size=ks, ranges=ranges, fold_center=fold)

        def affine(o):
            return torch.rand(o, generator=gen, device=dev) + 0.5, \
                rand(o) * 0.1
        pack1 = sfm.pack_level0_block(
            (rand(ks * ks, c, o1) / (4 * c) ** 0.5).to(bf),
            (rand(c, o1) / c ** 0.5).to(bf), *affine(o1), **kw)
        pack2 = sfm.pack_level0_block(
            (rand(ks * ks, o1, o2) / (4 * o1) ** 0.5).to(bf),
            (rand(o1, o2) / o1 ** 0.5).to(bf), *affine(o2), **kw,
            skip=((rand(c, o2) / c ** 0.5).to(bf), *affine(o2)))
        got = sfm.fused_two_block_cuda(src, prep, pack1, pack2, nodes,
                                       act=act)
        want = sfm.fused_two_block_plain(src, prep, pack1, pack2, nodes,
                                         act=act)
        torch.cuda.synchronize()
        for g, wt, what in zip(got, want, ("out", "h")):
            scale = wt.float().abs().max().item() + 1e-6
            err = (g.float() - wt.float()).abs().max().item() / scale
            if g.dtype != bf or g.shape != wt.shape \
                    or not bool((g[~nodes] == 0).all()) \
                    or not err <= KERNEL_TOL:
                raise AssertionError(
                    f"fused_two_block (C {c}, O {o1}/{o2}, {act}, taps "
                    f"{ranges}, {what}): {g.dtype} {tuple(g.shape)}, max "
                    f"abs err {err} of scale (tolerance {KERNEL_TOL}), or a "
                    f"masked row not zero")
            worst = max(worst, err)
    return worst, len(LEVEL0_CASES)


# K3 on shapes the main path does not reach: (C, O, Cs or None, activation,
# grid, items, share of slots that hold an edge).  The kernel picks its row
# tile by N and by what fits in shared memory; three cases make it pick 32
# rows, 128 rows, and 32 because 128 do not fit (the others get 16).  The
# last five take widths the kernel reaches by padding O to 8 and walking
# column groups: O 20, an odd O, O 256 from C 256 with a skip of 256
# (net_stem_width 2.0), two groups of 128, O 136 in a group of 128 and a
# ragged one of 8, and O 136 from C 256 on a grid whose window does not fit
# the 16-row tile beside a 128-column stage (groups of 64, 64 and 8)
SHIFT_CASES = [
    (5, 8, None, None, (7, 5), 3, 0.5),
    (82, 24, 82, "relu", (13, 9), 5, 0.3),
    (130, 64, 130, "elu", (14, 10), 3, 0.2),
    (64, 128, 130, "hardtanh", (13, 9), 5, 1.0),   # every slot an edge
    (82, 64, None, "silu", (28, 20), 3, 0.1),
    (33, 40, 7, "relu", (9, 7), 2, 0.4),           # odd C and Cs
    (82, 64, 82, "relu", (28, 20), 9, 0.1),        # 5 040 rows: 32 a block
    (82, 64, None, "elu", (57, 40), 6, 0.08),      # 13 680 rows: 128
    (130, 64, 130, "relu", (57, 40), 6, 0.08),     # 13 680 rows: 128 -> 32
    (82, 20, 82, "elu", (13, 9), 3, 0.3),          # O 20
    (5, 5, 7, "relu", (7, 5), 3, 0.5),             # an odd O
    (256, 256, 256, "relu", (14, 10), 3, 0.3),     # O 256, C 256
    (64, 136, None, "relu", (13, 9), 3, 0.3),      # O 136: 128 + 8
    (256, 136, 256, "elu", (28, 20), 3, 0.2),      # 64 + 64 + 8
]


def check_shift_general(dev):
    """K3 on the shapes of ``SHIFT_CASES``: N never a multiple of its row
    tile, the first 70 rows without any edge (whole tiles of 16 and 32),
    inputs from a seeded generator.  Against the plain version (f32 ``z``)
    within ``KERNEL_TOL``
    of the output's scale; the error against the plain version that rounds
    where the kernel rounds is returned beside it (both of scale), and the
    (C, O, Cs, N, row tile, column group) the launch picked for each case.
    Fails unless some case walks a last column group narrower than the
    others and some case has its groups narrowed below 128 by shared
    memory."""
    from eventad_tpu_torch.ops import spline_shift as ssm
    gen = torch.Generator(device=dev).manual_seed(31)
    bf = torch.bfloat16
    worst = worst_rounded = 0.0
    runs = 0
    plans = []

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    for c, o, cs, act, (nx, ny), items, share in SHIFT_CASES:
        n, ks = items * nx * ny, 5
        u = torch.rand((n, 25, 2), generator=gen, device=dev) * (ks - 1)
        edges = torch.rand((n, 25), generator=gen, device=dev) < share
        edges[:70] = False
        nodes = torch.rand((n,), generator=gen, device=dev) > 0.1
        prep = ssm.prepare_shift(u, edges, nodes, grid=(nx, ny), span=2,
                                 cart_max=2.0 / min(nx, ny), width=8 * nx,
                                 height=8 * ny, kernel_size=ks)
        src = rand(n, c).to(bf)
        ops = ((rand(ks * ks, c, o) / (4 * c) ** 0.5).to(bf),
               (rand(c, o) / c ** 0.5).to(bf),
               torch.rand(o, generator=gen, device=dev) + 0.5,
               rand(o) * 0.1)
        skip = None
        if cs is not None:
            skip = (rand(n, cs).to(bf), (rand(cs, o) / cs ** 0.5).to(bf),
                    torch.rand(o, generator=gen, device=dev) + 0.5,
                    rand(o) * 0.1)
        want = ssm.shift_spline_conv_plain(src, prep, *ops, act=act,
                                           skip=skip).float()
        rounded = ssm.shift_spline_conv_plain(
            src, prep, *ops, act=act, skip=skip,
            kernel_rounding=True).float()
        scale = want.abs().max().item() + 1e-6
        got = ssm.shift_spline_conv_cuda(src, prep, *ops, act=act, skip=skip)
        plans.append((c, o, cs, n) + ssm.shift_tiles(n, c, cs or 0, o, prep))
        torch.cuda.synchronize()
        if got.dtype != bf or got.shape != want.shape \
                or not bool((got[~nodes] == 0).all()):
            raise AssertionError(f"shift_spline_conv (C {c}, O {o}): "
                                 f"{got.dtype} {tuple(got.shape)}, or a "
                                 f"masked row is not zero")
        err = (got.float() - want).abs().max().item() / scale
        err_r = (got.float() - rounded).abs().max().item() / scale
        if not max(err, err_r) <= KERNEL_TOL:
            raise AssertionError(
                f"shift_spline_conv (C {c}, O {o}, Cs {cs}, {act}, N {n}): "
                f"max abs err {err} (f32 z) / {err_r} (bf16 z) of scale > "
                f"{KERNEL_TOL}")
        worst, worst_rounded = max(worst, err), max(worst_rounded, err_r)
        runs += 1
        del want, rounded, got
    pads = [(-(-o // 8) * 8, og) for _, o, _, _, _, og in plans]
    if not any(op % og for op, og in pads) \
            or not any(og < min(op, 128) for op, og in pads):
        raise AssertionError(f"SHIFT_CASES no longer reach a ragged last "
                             f"column group and a group narrowed by shared "
                             f"memory: {plans}")
    return worst, worst_rounded, runs, plans


# K5 on shapes the main path does not reach: (C, O, geometry, N, slots,
# share of slots that hold an edge, unaligned source).  "level0":
# neighbours up to 64 rows back, the 3 x 5 tap sub-rectangle; "pooled":
# neighbours up to 58 rows either side, all 25 taps.  The launch takes the
# slab kernel where 128-row blocks fill the card and every tap's weights fit
# beside them (the first two: O 4 and 40, so both of its instantiations),
# else the block kernel with its row tile by N (17 000 rows: 128; 13 680:
# 64; 3 360 and 5 000: 32; 840, 2 000, 300 and 100: 16), column groups by O
# (64 a group at 128 rows, else 128: O 512 in 8 and 4 groups, O 136 as 128
# + 8) and, where the tiles leave most SMs idle, clusters of blocks that
# share a tile's taps (300 rows: 4 blocks a tile, 100 rows: 8); both stage
# at most `cap` edge rows in shared memory (more edges in a tile: the rest
# are read from device memory); at C 512 the staging and the tile shrink
# until the block fits.  Two sources are views that start 38 bytes into
# their storage
FUSED_CASES = [
    (1, 4, "level0", 17000, 15, 0.05, False),
    (19, 40, "level0", 17000, 15, 0.6, True),
    (19, 13, "level0", 5000, 15, 0.3, True),
    (19, 512, "level0", 17000, 15, 0.02, False),
    (67, 136, "pooled", 13680, 25, 0.1, False),
    (82, 64, "pooled", 3360, 25, 1.0, False),
    (256, 256, "pooled", 840, 25, 0.3, False),
    (512, 512, "pooled", 840, 25, 0.2, False),
    (512, 4, "level0", 2000, 15, 0.3, False),
    (130, 64, "pooled", 300, 25, 0.3, False),
    (82, 136, "pooled", 100, 25, 0.5, False),
]


def check_fused_general(dev):
    """K5 on the shapes of ``FUSED_CASES``, the first 70 rows without an
    edge, inputs from a seeded generator: against the plain version from
    the same pack within ``FUSED_CONV_TOL`` of the output's scale, rows
    without an edge exactly zero.  Returns the worst error of scale, the
    number of cases and each case's (C, O, N, row tile, column group,
    staged rows, slab kernel, blocks a tile, most edges of a tile).  Fails
    unless the cases reach both kernels, every row tile of the block
    kernel, a tile shared by a cluster, a ragged last column group and a
    tile with more edges than it stages."""
    from eventad_tpu_torch.ops import spline_fused as sfm
    gen = torch.Generator(device=dev).manual_seed(61)
    ks, worst, plans = 5, 0.0, []
    for c, o, geo, n, k, share, offset in FUSED_CASES:
        rows = torch.arange(n, device=dev)[:, None]
        if geo == "level0":
            ranges = ((1, 3), (0, 4))
            nbr = rows - torch.randint(1, 65, (n, k), generator=gen,
                                       device=dev)
        else:
            ranges = ((0, 4), (0, 4))
            nbr = rows + torch.randint(-58, 59, (n, k), generator=gen,
                                       device=dev)
        edges = (torch.rand((n, k), generator=gen, device=dev) < share) \
            & (nbr >= 0) & (nbr < n)
        edges[:70] = False
        u = torch.rand((n, k, 2), generator=gen, device=dev) * (ks - 1)
        prep = sfm.prepare_fused(nbr.to(torch.int32), edges, u)
        src = torch.randn((n + int(offset), c), generator=gen,
                          device=dev).to(torch.bfloat16)[int(offset):]
        weight = torch.randn((ks * ks, c, o), generator=gen,
                             device=dev) / (4 * c) ** 0.5
        kw = dict(kernel_size=ks, ranges=ranges,
                  pack=sfm.pack_fused_weights(weight, kernel_size=ks,
                                              ranges=ranges))
        got = sfm.fused_spline_conv_cuda(src, prep, weight, **kw)
        want = sfm.fused_spline_conv_plain(src, prep, weight, **kw)
        (mx0, mx1), (my0, my1) = ranges
        tm, og, cap, slab, groups = sfm.fused_tiles(
            n, c, k, o, (mx1 - mx0 + 1) * (my1 - my0 + 1))
        per_tile = torch.zeros((-(-n // tm),), device=dev).index_add_(
            0, rows[:, 0] // tm, edges.sum(1).float())
        plans.append((c, o, n, tm, og, cap, slab, groups,
                      int(per_tile.max())))
        torch.cuda.synchronize()
        scale = want.abs().max().item() + 1e-6
        err = (got - want).abs().max().item() / scale
        if got.dtype != torch.float32 or got.shape != want.shape \
                or not bool((got[~edges.any(1)] == 0).all()) \
                or not err <= FUSED_CONV_TOL:
            raise AssertionError(
                f"fused_spline_conv (C {c}, O {o}, {geo}, N {n}): "
                f"{got.dtype} {tuple(got.shape)}, max abs err {err} of "
                f"scale (tolerance {FUSED_CONV_TOL}), or a row without an "
                f"edge not zero")
        worst = max(worst, err)
        del got, want, prep, src, weight
    if {p[3] for p in plans if not p[6]} != {128, 64, 32, 16} \
            or not any(p[6] for p in plans) \
            or not any(p[7] > 1 for p in plans) \
            or not any((-(-o // 8) * 8) % og for _, o, _, _, og, *_
                       in plans) \
            or not any(most > cap for *_, cap, _, _, most in plans):
        raise AssertionError(f"FUSED_CASES no longer reach both kernels, "
                             f"every row tile of the block kernel, a tile "
                             f"shared by a cluster, a ragged column group "
                             f"and a tile with more edges than it stages: "
                             f"{plans}")
    return worst, len(FUSED_CASES), plans


def check_gather_wide(dev):
    """K6a's 64-bit instantiation (the rule for an output of 2^31 elements
    or more): one bf16 gather of C 19, K 15 and 2^31 + 2^20 elements or
    more (4.3 GB), neighbours up to 1023 rows back, half the slots edges,
    from a seeded generator; the output's rows at 8192 random rows, the 128
    rows around flat index 2^31 and the last 64 rows must equal the plain
    version's exactly.  Returns the rows checked and the element count."""
    from eventad_tpu_torch.ops import gather_window as gw
    c, k = 19, 15
    n = -(-(2 ** 31 + 2 ** 20) // (k * c))
    gen = torch.Generator(device=dev).manual_seed(71)
    src = torch.randn((n, c), generator=gen, device=dev).to(torch.bfloat16)
    back = torch.randint(0, 1024, (n, k), generator=gen, device=dev,
                         dtype=torch.int32)
    nbr = (torch.arange(n, device=dev, dtype=torch.int32)[:, None]
           - back).clamp_(min=0)
    del back
    mask = torch.rand((n, k), generator=gen, device=dev) < 0.5
    out = gw.gather_window_rows_cuda(src, nbr, mask, lookback=1023)
    edge_row = 2 ** 31 // (k * c)
    pick = torch.cat([
        torch.randint(0, n, (8192,), generator=gen, device=dev),
        torch.arange(edge_row - 64, edge_row + 64, device=dev),
        torch.arange(n - 64, n, device=dev)])
    want = gw.gather_window_rows_plain(src, nbr[pick], mask[pick])
    torch.cuda.synchronize()
    if out.shape != (n, k, c) or not torch.equal(out[pick], want):
        raise AssertionError("gather_window_rows (64-bit, bf16): kernel != "
                             "plain version")
    total = out.numel()
    del out, src, nbr, mask
    torch.cuda.empty_cache()
    return pick.numel(), total


def compare(name, got, want, kw=None):
    """Max abs error of the kernel's outputs against the plain version's;
    raises if outside the stated tolerance.  ``kw``: the call's keywords
    (K8 reads its geometry there)."""
    if name == "pool_graph":
        return compare_pool(got, want, kw)
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


# K8 against the plain formulation, summed over the compared calls: cells,
# cells whose pooled position is one pixel step from the plain one's, and
# pos_nbr entries likewise
POOL_STATS = dict(calls=0, cells=0, step_cells=0, step_pos_nbr=0)


def compare_pool(got, want, kw):
    """K8's outputs against the plain formulation's on the same call: the
    features of a max pooling, ``nbr``, ``nbr_mask``, ``active`` and the
    batch column exactly; a mean pooling's features within one rounding of
    their type of scale; the pooled ``t`` within f32 rounding of scale
    (both sum by f32 atomics, in an order of their own); the pooled ``x``,
    ``y`` and ``pos_nbr`` equal, except where a cell's f32 mean lies within
    that rounding of a pixel boundary: there one pixel step (``1/width``,
    ``1/height``) apart, in at most 1 % of the active cells (counted in
    ``POOL_STATS``).  Returns the largest error of the features and ``t``
    against their scale."""
    if kw.get("return_pos_nbr"):
        (g, gpn), (w, wpn) = got, want
    else:
        g, w, gpn, wpn = got, want, None, None
    for f in ("x", "pos", "nbr", "nbr_mask", "node_mask", "batch"):
        a, b = getattr(g, f), getattr(w, f)
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"pool_graph {f}: {a.shape}/{a.dtype} vs "
                                 f"{b.shape}/{b.dtype}")
    exact = ["nbr", "nbr_mask", "node_mask", "batch"]
    if kw.get("aggr", "max") == "max":
        exact.append("x")
    for f in exact:
        if not torch.equal(getattr(g, f), getattr(w, f)):
            raise AssertionError(f"pool_graph: {f} differs from the plain "
                                 f"formulation")

    def rel(a, b):
        return ((a.float() - b.float()).abs().max().item()
                / (b.float().abs().max().item() + 1e-6))
    err = rel(g.pos[:, 2], w.pos[:, 2])
    if not err <= 1e-5:
        raise AssertionError(f"pool_graph: pooled t off by {err} of scale")
    if "x" not in exact:
        x_tol = 2.0 ** -8 if w.x.dtype == torch.bfloat16 else 1e-6
        x_err = rel(g.x, w.x)
        if not x_err <= x_tol:
            raise AssertionError(f"pool_graph (mean): features off by "
                                 f"{x_err} of scale > {x_tol}")
        err = max(err, x_err)
    step = torch.tensor([1.0 / kw["width"], 1.0 / kw["height"]],
                        device=w.pos.device)

    def stepped(a, b):
        """Entries apart, each exactly one pixel step apart."""
        d = (a - b).abs()
        off = d > 0
        if bool((off & ((d - step).abs() > 1e-6)).any()):
            raise AssertionError(f"pool_graph: a pooled position off by "
                                 f"{d.max().item()}, not one pixel step")
        return off.any(-1)
    cells = int(stepped(g.pos[:, :2], w.pos[:, :2]).sum())
    POOL_STATS["calls"] += 1
    POOL_STATS["cells"] += w.pos.shape[0]
    POOL_STATS["step_cells"] += cells
    if gpn is not None:
        POOL_STATS["step_pos_nbr"] += int(stepped(gpn, wpn).sum())
    if cells > max(1, int(w.node_mask.sum()) // 100):
        raise AssertionError(f"pool_graph: {cells} cells one pixel step "
                             f"from the plain formulation, of "
                             f"{int(w.node_mask.sum())} active")
    return err


def pool_variants(a, kw):
    """K8's cases on a recorded call: as recorded; through ``nbr`` with
    the temporal ordering; f32 features with the other aggregation and
    ``pos_nbr``; f32 through ``nbr`` with the temporal ordering and
    ``pos_nbr``."""
    other = "mean" if kw["aggr"] == "max" else "max"
    x32 = (a[0].float(),) + tuple(a[1:])
    return [(a, kw),
            (a, dict(kw, pos_src=None, keep_temporal_ordering=True)),
            (x32, dict(kw, aggr=other, return_pos_nbr=True)),
            (x32, dict(kw, pos_src=None, keep_temporal_ordering=True,
                       return_pos_nbr=True))]


def check_pool_cases(calls):
    """K8 on every variant (:func:`pool_variants`) of the recorded pooling
    calls against the plain formulation; ``(cases, worst error)``."""
    from eventad_tpu_torch.ops import pooling
    n, err = 0, 0.0
    for a, kw in calls:
        for va, vkw in pool_variants(a, kw):
            got = pooling.pool_graph_cuda(*va, **vkw)
            torch.cuda.synchronize()
            err = max(err, compare_pool(
                got, pooling.pool_graph_plain(*va, **vkw), vkw))
            n += 1
    return n, err


def recorded(mod, attr, fn):
    """``fn()`` with the arguments of ``mod.<attr>`` recorded: ``(out,
    [(args, kwargs), ...])``."""
    calls, orig = [], getattr(mod, attr)

    def rec(*a, **kw):
        calls.append((a, kw))
        return orig(*a, **kw)
    setattr(mod, attr, rec)
    try:
        out = fn()
        torch.cuda.synchronize()
    finally:
        setattr(mod, attr, orig)
    return out, calls


# K9: the detection read-out's keywords (``models.detector.
# decode_detections``) at the operating point, for the planted cases
NMS_KW = dict(conf_threshold=0.001, nms_threshold=0.65, width=360,
              height=240)


def iou_pair(target, x0, y0, gen, tries=20000):
    """Two decoded anchors ``[2, 4]`` (cx, cy, w, h) at ``(x0, y0)``, the
    second inside the first, whose IoU as the plain version computes it
    (``yolox_head._iou_matrix`` of the boxes ``postprocess_plain`` forms) is
    exactly the f32 ``target``: a seeded random search on the CPU, whose f32
    operations round as the card's."""
    from eventad_tpu_torch.models import yolox_head as yh
    wa = 8 + 4 * torch.rand(tries, generator=gen)
    ha = 8 + 4 * torch.rand(tries, generator=gen)
    wb = wa * (NMS_KW["nms_threshold"]
               + (torch.rand(tries, generator=gen) - 0.5) * 2e-6)
    d = torch.stack([torch.stack([x0 + wa / 2, y0 + ha / 2, wa, ha], -1),
                     torch.stack([x0 + wb / 2, y0 + ha / 2, wb, ha], -1)],
                    1)
    xy = d[..., :2] - d[..., 2:4] / 2
    iou = yh._iou_matrix(torch.cat([xy, xy + d[..., 2:4]], -1))[:, 0, 1]
    hit = torch.nonzero(iou == target).flatten()
    if not len(hit):
        raise AssertionError(f"no box pair of IoU {target.item()!r} found")
    return d[hit[0]]


def nms_cases(dev):
    """K9's planted cases, ``(name, (decoded [B, A, 5 + C] on dev, C),
    keywords)``, from a seeded generator: tied scores (multiples of 1/8),
    at the read-out's IoU threshold and at 0.1; three box pairs whose IoU
    is one f32 ulp below 0.65, 0.65 and one ulp above (the second box of
    each kept, kept, suppressed); inf w or h (NaN corners), NaN and inf
    scores, NaN class probabilities, a NaN x; every score below the
    threshold; fewer than 64 survivors; 128 and 129 anchors with tied
    scores (PyTorch sorts up to 128 by merging, above by radix); 40 anchors
    and one (A < 64); and ``MAX_ANCHORS`` anchors of ``MAX_CLASSES``
    classes, K9's largest shared memory."""
    from eventad_tpu_torch.ops import nms
    gen = torch.Generator().manual_seed(9)
    inf, nan = float("inf"), float("nan")

    def rand(b, a, c=2, tied=False):
        d = torch.rand(b, a, 5 + c, generator=gen)
        d[..., :2] = d[..., :2] * 90 + 30    # boxes within x, y 14 to 136
        d[..., 2:4] = d[..., 2:4] * 30 + 2
        if tied:
            d[..., 4:] = torch.round(d[..., 4:] * 8) / 8
        return d
    tied = rand(3, 175, tied=True)
    cases = [("tied", tied, 2, NMS_KW),
             ("tied_iou_0.1", tied, 2, dict(NMS_KW, nms_threshold=0.1))]
    d = rand(2, 175)
    thr = torch.tensor(NMS_KW["nms_threshold"])
    for j, t in enumerate((torch.nextafter(thr, torch.tensor(0.0)), thr,
                           torch.nextafter(thr, torch.tensor(1.0)))):
        d[:, 2 * j:2 * j + 2, :4] = iou_pair(t, 200.0 + 20 * j, 200.0, gen)
        d[:, 2 * j, 4:] = torch.tensor([1.0, 0.99, 0.01])
        d[:, 2 * j + 1, 4:] = torch.tensor([1.0, 0.98, 0.01])
    cases.append(("iou_ulp", d, 2, NMS_KW))
    d = rand(2, 175)
    d[:, :12, 4] = 1.0                 # scored first
    d[:, 0, 2] = inf
    d[:, 1, 3] = inf
    d[:, 2, 2:4] = inf
    d[:, 3, 4] = nan
    d[:, 4, 5] = nan
    d[:, 5, 6] = nan
    d[:, 6, 4] = inf
    d[:, 7, 0] = nan
    cases.append(("inf_nan", d, 2, NMS_KW))
    d = rand(2, 175)
    d[..., 4] *= 0.0009
    cases.append(("all_below", d, 2, NMS_KW))
    d = rand(2, 175)
    d[..., 4] *= 0.002
    cases.append(("few", d, 2, NMS_KW))
    cases += [("tied_128", rand(2, 128, tied=True), 2, NMS_KW),
              ("tied_129", rand(2, 129, tied=True), 2, NMS_KW),
              ("small", rand(2, 40), 2, NMS_KW),
              ("one", rand(1, 1), 2, NMS_KW),
              ("widest", rand(2, nms.MAX_ANCHORS, nms.MAX_CLASSES),
               nms.MAX_CLASSES, dict(NMS_KW, nms_threshold=0.3))]
    return [(n, (x.to(dev), c), kw) for n, x, c, kw in cases]


def same_detections(got, want):
    """Whether two detection dicts hold the same keys, shapes, dtypes and
    bits (a NaN's too)."""
    if set(got) != set(want):
        return False
    for k, b in want.items():
        a = got[k]
        if a.shape != b.shape or a.dtype != b.dtype:
            return False
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not torch.equal(a, b):
            return False
    return True


def check_postprocess(dev, smi, inputs, records):
    """K9 (``ops.nms.postprocess_cuda``) against the plain
    ``postprocess_plain`` on the card, bit for bit on all four outputs and
    all slots: on the main path's recorded calls ``inputs`` (name ->
    ``(args, kwargs)``) and on :func:`nms_cases`, whose ``iou_ulp`` masks
    must also equal the plain version's on the CPU (the planted IoUs land
    on the card where they land there).  Times at the stream's and the
    batch detector's shapes; appends K9's record."""
    from eventad_tpu_torch.models import yolox_head as yh
    from eventad_tpu_torch.ops import nms
    cases = [(n, a, kw) for n, (a, kw) in inputs.items()] + nms_cases(dev)
    kept = {}
    for name, a, kw in cases:
        got = nms.postprocess_cuda(*a, **kw)
        want = yh.postprocess_plain(*a, **kw)
        torch.cuda.synchronize()
        if not same_detections(got, want):
            raise AssertionError(f"postprocess ({name}): K9 differs from "
                                 f"the plain version")
        kept[name] = [int(m) for m in got["mask"].sum(-1)]
        if name == "iou_ulp":
            cpu = yh.postprocess_plain(a[0].cpu(), *a[1:], **kw)
            if not torch.equal(cpu["mask"], got["mask"].cpu()):
                raise AssertionError("postprocess (iou_ulp): the card's "
                                     "masks differ from the CPU's")
    rec = dict(name="postprocess", route="cuda",
               source="eventad_tpu_torch/csrc/nms.cu",
               replaces="none: XLA lowers eventad_tpu/models/yolox_head.py:"
                        "postprocess", launches=1, max_abs_err=0.0,
               cases=len(cases), bound_by="bytes (the launch at these "
                                           "sizes)", library_ms=None)
    for key, name in (("", "stream_bfloat16_0"), ("batch_", "batch")):
        a, kw = inputs[name]
        out = nms.postprocess_cuda(*a, **kw)
        rec.update({
            key + "ms": median_ms(lambda: nms.postprocess_cuda(*a, **kw)),
            key + "launch_ms": launch_ms(
                nms, lambda: nms.postprocess_cuda(*a, **kw)),
            key + "plain_ms": median_ms(
                lambda: yh.postprocess_plain(*a, **kw)),
            key + "bound_ms": tensor_bytes((a, out)) / HBM_BYTES_PER_S
            * 1e3})
    records.append(rec)
    log(f"postprocess (K9): bit-identical to the plain version on "
        f"{len(cases)} cases (kept per image {kept}); the stream's read "
        f"(1, 175, 7): kernel {rec['ms']:.4f} ms, alone "
        f"{rec['launch_ms']:.4f} ms, plain {rec['plain_ms']:.4f} ms, bound "
        f"{rec['bound_ms']:.6f} ms (bytes; launch-bound at this size); the "
        f"batch detector's (6, 175, 7): kernel {rec['batch_ms']:.4f} ms, "
        f"alone {rec['batch_launch_ms']:.4f} ms, plain "
        f"{rec['batch_plain_ms']:.4f} ms, bound {rec['batch_bound_ms']:.6f}"
        f" ms; on {smi}")


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
    src, prep, pack1, pack2, node_mask = a
    c, c1, c2 = src.shape[1], pack1.o, pack2.o
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


def upsample_library(a, out):
    """K4's library column: ``F.grid_sample(mode="bilinear",
    align_corners=True)`` of each map at the events' normalised pixel
    coordinates ``2 xi / (W - 1) - 1``, which samples the same align-corners
    taps as K4 (the rows grouped by item, as the main path has them).
    Returns ``(max abs diff, ms, alone ms)``: the difference of the library
    in f32, rounded to bf16, from the plain version's output ``out``; the
    wrapper median in the maps' type including what it needs around the
    call (the pixel rounding and the grid, the NCHW copies, the output's
    transpose into one table); and its ``grid_sample`` calls alone, on
    prepared maps and grid, by the graph replay of K7's library column."""
    import torch.nn.functional as F

    from eventad_tpu_torch.models.graph import pixel_index
    feats, pos, batch, width, height = a
    b, n = feats[0].shape[0], pos.shape[0]
    items = torch.arange(b, dtype=batch.dtype, device=batch.device)
    if n % b or not torch.equal(batch, items.repeat_interleave(n // b)):
        raise AssertionError("upsample_rows: the library call needs the "
                             "rows grouped by item")

    def grid_of(dtype):
        xi, yi = pixel_index(pos, width, height)
        gx = xi.float() * 2 / max(width - 1, 1) - 1
        gy = yi.float() * 2 / max(height - 1, 1) - 1
        return torch.stack([gx, gy], -1).reshape(b, 1, n // b, 2).to(dtype)

    def sample(maps, grid):
        return [F.grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                              align_corners=True) for x in maps]

    def library(dtype):
        maps = [f.to(dtype).permute(0, 3, 1, 2).contiguous() for f in feats]
        outs = sample(maps, grid_of(dtype))
        return torch.cat([o[:, :, 0].permute(0, 2, 1).reshape(n, -1)
                          for o in outs], 1)
    diff = (library(torch.float32).to(out.dtype).float()
            - out.float()).abs().max().item()
    dtype = feats[0].dtype
    ms = median_ms(lambda: library(dtype))
    maps = [f.permute(0, 3, 1, 2).contiguous() for f in feats]
    grid = grid_of(dtype)
    alone = graph_ms(lambda: sample(maps, grid))
    return diff, ms, alone


def bound(nbytes, ops, peak):
    """``(bound_ms, bound_by)``: the larger of bytes over the memory rate
    and operations over their peak rate."""
    by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, ops / peak
    return (max(by_bytes, by_ops) * 1e3,
            "bytes" if by_bytes >= by_ops else "operations")


def pool_ops(a, kw, out):
    """K8: per node one operation a channel and six per edge slot (its
    source cell, offset and bit), per cell one a channel and six a slot."""
    x, nbr = a[0], a[2]
    g = out[0] if kw.get("return_pos_nbr") else out
    n, c = x.shape
    m, s = g.nbr.shape
    return n * c + 6 * n * nbr.shape[1] + m * (c + 6 * s), PEAK_F32


OPS = {"event_graph_search": search_ops, "spline_fused_level0": level0_ops,
       "spline_shift_pooled": shift_ops, "upsample_rows": upsample_ops,
       "pool_graph": pool_ops}


def all_bytes(a, kw, out):
    """Every tensor among the arguments read once, the result written."""
    return tensor_bytes(a) + tensor_bytes(kw) + tensor_bytes(out)


def level0_bytes(a, kw, out):
    """K2: the source rows, the neighbour table, coordinates only of the
    slots that hold an edge (an empty slot's are never read), the node mask,
    of each pack the values of its used taps, root and skip and its affines
    (not the pads of the kernel's layout, neither columns nor rows), both
    outputs."""
    src, prep, pack1, pack2, node_mask = a
    packs = sum(((pk.taps.shape[0] + 1) * pk.c + pk.cs) * pk.o
                * pk.taps.element_size()
                + pk.o * 4 * pk.ab.element_size() for pk in (pack1, pack2))
    return (tensor_bytes((src, prep.nbr, node_mask, out)) + packs
            + int((prep.nbr >= 0).sum()) * 2 * prep.u.element_size())


def shift_bytes(a, kw, out):
    """K3: the source rows, the edge mask in full (it says which slots hold
    an edge) and the node mask, coordinates only of the slots that hold an
    edge, the static offset and tap lists, of the weights the used taps,
    root, the affines and the skip operands, and the output.  Not the
    tables the kernel does not take (``tap_idx``, ``win_mask``) and not the
    pack, which holds the same weights again."""
    src, prep, weight, root, scale, offset = a
    return (tensor_bytes((src, prep.mq, prep.node_mask, prep.d_offs,
                          prep.tap_mxy, prep.tap_ptr, prep.tap_slots, root,
                          scale, offset, kw.get("skip"), out))
            + int(prep.mq.sum()) * 2 * prep.u.element_size()
            + prep.tap_idx.shape[0] * weight[0].numel()
            * weight.element_size())


def pool_bytes(a, kw, out):
    """K8: the features, positions, node mask and batch, the edge mask
    and, with ``pos_src``, the source positions (else ``nbr``) read once;
    the outputs written once (the workspace stays in L2)."""
    x, pos, nbr, nbr_mask, node_mask, batch = a
    src = kw.get("pos_src")
    return tensor_bytes((x, pos, nbr_mask, node_mask, batch,
                         nbr if src is None else src, out))


BYTES = {"spline_fused_level0": level0_bytes,
         "spline_shift_pooled": shift_bytes, "pool_graph": pool_bytes}


# phase 9: the root bench_streaming.py's operating point (batch 1, a ring
# of 16 384 events, chunks of 512), steps run against the CPU, timed steps
STREAM_BUF, STREAM_CHUNK = 16384, 512
STREAM_STEPS = 8
STREAM_ITERS = 20


def stream_frames(cfg, m, seed=1):
    """``m`` frames of boxes (xywh pixels, 20-60 px a side, inside the
    sensor), about half of the slots present, slot 0 never."""
    gen = torch.Generator().manual_seed(seed)
    s1 = cfg.max_boxes + 1
    wh = 20 + 40 * torch.rand((m, s1, 2), generator=gen)
    lim = torch.tensor([cfg.model_width, cfg.model_height]) - wh
    xy = torch.rand((m, s1, 2), generator=gen) * lim
    present = torch.rand((m, s1), generator=gen) > 0.5
    present[:, 0] = False
    return torch.cat([xy, wh], -1), present


def streaming_phase(dev, smi, cfg, model, cpu_model, bc, mc, gsc, detector,
                    records, zero_counters, read_counters, maps_err,
                    nms_inputs):
    """Phase 9: streaming at full width (see the module docstring).  Each
    detection read's ``postprocess`` call goes into ``nms_inputs`` (name
    -> ``(args, kwargs)``) for K9's check."""
    import importlib

    from eventad_tpu_torch.data.batching import EventBatch
    from eventad_tpu_torch.models import detector as mdet
    from eventad_tpu_torch.models.detector import (detector_forward,
                                                   detector_maps)
    from eventad_tpu_torch.models import yolox_head as yh
    from eventad_tpu_torch.models.eventad import EventADConfig
    from eventad_tpu_torch.ops import event_graph as egm
    from eventad_tpu_torch.ops import spline_shift as ssm
    from eventad_tpu_torch.streaming import detect as sdet
    from eventad_tpu_torch.streaming import incremental as inc
    from eventad_tpu_torch.streaming.evaluate import (
        SyntheticStream, consistency_check, latency_bench,
        latency_bench_incremental)
    from eventad_tpu_torch.streaming.runner import insert_events
    from eventad_tpu_torch.streaming.runner import make_stream_step
    from eventad_tpu_torch.streaming.runner import \
        update_image as dense_update_image
    from eventad_tpu_torch.streaming.state import init_streaming_state

    bb = importlib.import_module("eventad_tpu_torch.models.backbone")
    cfg1 = cfg.replace(batch_size=1)
    bc1 = bc._replace(batch_size=1)
    bc1_32 = bc1._replace(compute_dtype="float32")
    n_buf, k = STREAM_BUF, STREAM_CHUNK
    ev = SyntheticStream(cfg1, k, 0, "cpu")
    image = ev.image()
    fill = [ev.chunk() for _ in range(n_buf // k)]
    chunks = [ev.chunk() for _ in range(STREAM_STEPS + 1)]
    boxes, present = stream_frames(cfg1, STREAM_STEPS)
    ones = torch.ones((k,))
    log(f"streaming: batch 1, {cfg1.model_width}x{cfg1.model_height}, "
        f"ring {n_buf} events, chunks of {k}, {cfg1.img_net}, "
        f"{bc1.compute_dtype} features, f32 head")

    def stream(m, d, bcx, n_fill=len(fill)):
        """The incremental stream on device ``d``: the image, ``n_fill``
        chunks inserted raw, a refresh, then one step per frame."""
        refresh, step = inc.make_incremental_step(m, bcx, mc, gsc,
                                                  n_chunk=k, n_buf=n_buf)
        st = inc.update_image(m, inc.init_incremental_state(
            n_buf, bcx, mc, device=d), image.to(d))
        for c in fill[:n_fill]:
            st = inc.insert_raw(st, c.to(d), ones.to(d), k)
        return refresh, step, refresh(st)

    def steps(step, st, d):
        logits = []
        for c, bx, bp in zip(chunks, boxes, present):
            st, lg = step(st, c.to(d), ones.to(d), k, bx.to(d), bp.to(d))
            logits.append(lg)
        return st, torch.stack(logits).cpu()

    # ---- 9.1 incremental scoring, bf16, against the port on the CPU ----
    t0 = time.perf_counter()
    refresh, step, st0 = stream(model, dev, bc1)
    st, gpu_logits = steps(step, st0, dev)
    _, cpu_step, cpu_st0 = stream(cpu_model, "cpu", bc1)
    _, cpu_logits = steps(cpu_step, cpu_st0, "cpu")
    valid, cpu_valid = ((x != 0).any(-1) for x in (gpu_logits, cpu_logits))
    if not (torch.equal(valid, cpu_valid) and valid[-1].any()
            and bool(torch.isfinite(gpu_logits).all())):
        raise AssertionError("streaming: valid slots differ from the CPU "
                             "run, none on the last step, or logits not "
                             "finite")
    d_stream = (gpu_logits - cpu_logits).abs().max().item()
    log(f"streaming (bf16): {STREAM_STEPS} steps after the refresh, "
        f"{int(valid.sum())} valid slots ({int(valid[-1].sum())} on the "
        f"last); GPU vs CPU logits max abs diff {d_stream:.3g} (tolerance "
        f"{LOGIT_TOL}); {time.perf_counter() - t0:.1f} s with the CPU run")
    if not d_stream < LOGIT_TOL:
        raise AssertionError(f"streaming logits differ from the CPU by "
                             f"{d_stream}")

    # ---- 9.2 f32 consistency: stream against batch, one window ----
    cfg32 = cfg1.replace(compute_dtype="float32")
    window = torch.cat(fill)
    pol = torch.where(torch.rand(n_buf, generator=torch.Generator()
                                 .manual_seed(3)) > 0.5, 1.0, -1.0)
    diff, batch_logits, _ = consistency_check(
        model, cfg32, window.numpy(), pol.numpy(), boxes[-1].numpy(),
        present[-1].numpy(), n_chunks=4)
    refresh32, step32 = inc.make_incremental_step(model, bc1_32, mc, gsc,
                                                  n_chunk=k, n_buf=n_buf)
    st32 = inc.update_image(model, inc.init_incremental_state(
        n_buf, bc1_32, mc, device=dev), torch.zeros_like(image, device=dev))
    st32 = refresh32(inc.insert_raw(st32, fill[0].to(dev),
                                    pol[:k].to(dev), k))
    for i in range(1, len(fill)):
        st32 = step32.append(st32, fill[i].to(dev),
                             pol[i * k:(i + 1) * k].to(dev), k)
    _, inc_logits = step32.read_scores(st32, boxes[-1].to(dev),
                                       present[-1].to(dev))
    v = present[-1]
    d_inc = (inc_logits.cpu()[v] - batch_logits[v]).abs().max().item()
    log(f"streaming consistency (f32, one window of {n_buf} events, "
        f"{int(v.sum())} boxes): dense stream (4 chunks) vs batch "
        f"model_forward max abs diff {diff:.3g}, incremental (refresh + "
        f"{len(fill) - 1} appends + read) vs batch {d_inc:.3g} (tolerance "
        f"{F32_LOGIT_TOL})")
    if not (diff < F32_LOGIT_TOL and d_inc < F32_LOGIT_TOL):
        raise AssertionError("f32 stream differs from the batch path")

    # ---- 9.3 launches, and K1-K4 at the streaming shapes ----
    zero_counters()
    st1 = step.append(st, chunks[-1].to(dev), ones.to(dev), k)
    torch.cuda.synchronize()
    per_append = read_counters({"event_graph_search": 1}, "one append")
    zero_counters()
    step.read_scores(st1, boxes[-1].to(dev), present[-1].to(dev))
    torch.cuda.synchronize()
    per_read = read_counters({"spline_shift_pooled": 8, "pool_graph": 8,
                              "bilinear_sample": 3}, "one read_scores")
    sst = dense_update_image(model, init_streaming_state(
        n_buf, cfg1.max_boxes, cfg1.h_dim, device=dev), image.to(dev))
    for c in fill:
        sst = insert_events(sst, c.to(dev), ones.to(dev), k)
    dense_step = make_stream_step(model, bc1, mc, gsc, n_chunk=k)

    def dense_once():
        return dense_step(sst, chunks[0].to(dev), ones.to(dev), k,
                          boxes[0].to(dev), present[0].to(dev))
    dense_once()
    zero_counters()
    dense_once()
    torch.cuda.synchronize()
    per_dense = read_counters(dict(event_graph_search=1, upsample_rows=1,
                                   spline_fused_level0=2,
                                   spline_shift_pooled=8, bilinear_sample=3,
                                   pool_graph=8),
                              "one dense streaming step")
    log(f"streaming launches: one append {per_append}, one read_scores "
        f"{per_read}, one dense step (bf16) {per_dense}")

    spec = {kk[0]: kk for kk in KERNELS}

    def held(name, calls, launches, extra_bytes=0):
        """Kernel ``name``'s wrapper on each recorded call, held against its
        plain version (``compare``) and timed as in phase 3; the record of
        the calls together, with their bound."""
        mod = importlib.import_module(f"eventad_tpu_torch.ops."
                                      f"{spec[name][1]}")
        cuda_fn, plain_fn = (getattr(mod, f) for f in spec[name][2:4])
        first = [t for x in calls[0][0]
                 for t in (x if isinstance(x, (list, tuple)) else [x])]
        r = dict(shapes=[list(t.shape) for t in first
                         if isinstance(t, torch.Tensor)],
                 ms=0.0, launch_ms=0.0, plain_ms=0.0, launches=launches,
                 max_abs_err=0.0, library_ms=None)
        nbytes, ops = 0, 0
        for a, kw in calls:
            got = cuda_fn(*a, **kw)
            r["max_abs_err"] = max(r["max_abs_err"], compare(
                name, got, plain_fn(*a, **kw), kw))
            r["ms"] += median_ms(lambda: cuda_fn(*a, **kw))
            r["launch_ms"] += launch_ms(mod, lambda: cuda_fn(*a, **kw))
            r["plain_ms"] += median_ms(lambda: plain_fn(*a, **kw))
            nbytes += BYTES.get(name, all_bytes)(a, kw, got) + extra_bytes
            n_ops, peak = OPS[name](a, kw, got)
            ops += n_ops
        r["bound_ms"], r["bound_by"] = bound(nbytes, ops, peak)
        return r

    def timing(r):
        return (f"kernel {r['ms']:.4f} ms, alone {r['launch_ms']:.4f}, plain "
                f"{r['plain_ms']:.4f}, bound {r['bound_ms']:.5f} ms by "
                f"{r['bound_by']}")

    # K2 and K4 as the dense step calls them (batch 1, one item of n_buf
    # rows, one image map)
    (_, k4_calls), k2_calls = recorded(
        importlib.import_module("eventad_tpu_torch.ops.spline_fused"),
        "fused_two_block",
        lambda: recorded(bb, "upsample_rows", dense_once))
    k2_rec = held("spline_fused_level0", k2_calls,
                  per_dense["spline_fused_level0"])
    k4_rec = held("upsample_rows", k4_calls, per_dense["upsample_rows"])
    lib = [upsample_library(a, importlib.import_module(
        "eventad_tpu_torch.ops.upsample_flat").upsample_rows_plain(*a, **kw))
        for a, kw in k4_calls]
    k4_rec.update(library_ms=sum(x[1] for x in lib),
                  library_launch_ms=sum(x[2] for x in lib),
                  library_max_abs_diff=max(x[0] for x in lib))
    for name, r, calls in (("spline_fused_level0", k2_rec, k2_calls),
                           ("upsample_rows", k4_rec, k4_calls)):
        log(f"{name}, the dense step's shapes: {len(calls)} call(s) a step,"
            f" inputs {r['shapes']}; max abs err {r['max_abs_err']:.3g} "
            f"(tolerance {KERNEL_TOL} of scale); per step: {timing(r)}")
    log(f"upsample_rows, the dense step's shapes: F.grid_sample "
        f"{k4_rec['library_ms']:.4f} ms, alone "
        f"{k4_rec['library_launch_ms']:.4f}, max abs diff from the plain "
        f"version {k4_rec['library_max_abs_diff']:.3g}")

    # K1 as an append and as the refresh of a ring still filling call it
    _, app_calls = recorded(inc, "build_graph_auto", lambda: step.append(
        st, chunks[-1].to(dev), ones.to(dev), k))
    _, fill_calls = recorded(inc, "build_graph_auto", lambda: stream(
        model, dev, bc1, n_fill=len(fill) * 5 // 8))
    k1_in = {}
    for what, calls in (("append", app_calls), ("filling", fill_calls)):
        (a, kw), = calls
        kw = {n: x for n, x in kw.items() if n != "grid_wh"}
        compare("event_graph_search", egm.build_graph_cuda(*a, **kw),
                egm.build_graph(*a, **kw))
        k1_in[what] = (a, kw)
    a, kw = k1_in["append"]
    # the inputs, the queue ranks the wrapper computes and the outputs
    k1_rec = held("event_graph_search", [(a, kw)], 1,
                  extra_bytes=a[1].numel() * 4)
    fa, _ = k1_in["filling"]
    n_invalid = int((~fa[1]).sum())
    log(f"event_graph_search, streaming shapes: an append's tail "
        f"{tuple(a[0].shape)} (absolute times, lookback {kw['lookback']}) "
        f"and the refresh of a ring still filling {tuple(fa[0].shape)} "
        f"({n_invalid} invalid rows first, t = 0): equal to the plain "
        f"version exactly; per append: {timing(k1_rec)}")

    # K3 in two reads: the same packs and static tables, each call held
    # against its plain version
    reads = [recorded(bb, "shift_spline_conv", lambda: step.read_scores(
        st1, boxes[-1].to(dev), present[-1].to(dev)))[1] for _ in range(2)]
    static = ("d_offs", "tap_mxy", "tap_ptr", "tap_slots", "tap_idx",
              "win_mask")
    for (a, kw), (a2, kw2) in zip(*reads):
        if any(getattr(a[1], f) is not getattr(a2[1], f) for f in static):
            raise AssertionError("K3 (read_scores): a static table was "
                                 "made anew")
        if any(x is not y for x, y in zip(a[2:], a2[2:])) \
                or kw["pack"] is None or kw["pack"] is not kw2["pack"]:
            raise AssertionError("K3 (read_scores): operands were packed "
                                 "anew")
    k3_rec = held("spline_shift_pooled", reads[0], 8)
    log(f"spline_shift_pooled, streaming shapes: 8 calls per read_scores "
        f"(first inputs {k3_rec['shapes']}), a second read reuses the "
        f"static tables and the packs (same objects); max abs err "
        f"{k3_rec['max_abs_err']:.3g}; per read: {timing(k3_rec)}")
    # K8 at a read's batch-1 grids, each call also in four variants
    _, read_pools = recorded(bb, "pool_graph", lambda: step.read_scores(
        st1, boxes[-1].to(dev), present[-1].to(dev)))
    POOL_STATS.update(calls=0, cells=0, step_cells=0, step_pos_nbr=0)
    k8_rec = held("pool_graph", read_pools, 8)
    p_cases, p_err = check_pool_cases(read_pools)
    log(f"pool_graph, streaming shapes: {len(read_pools)} calls per "
        f"read_scores (rows in {[a[0].shape[0] for a, _ in read_pools]}); "
        f"{p_cases} variant cases: exact where exact, mean features and t "
        f"within {max(p_err, k8_rec['max_abs_err']):.3g} of scale; "
        f"{POOL_STATS['step_cells']} of {POOL_STATS['cells']} cells and "
        f"{POOL_STATS['step_pos_nbr']} pos_nbr entries one pixel step "
        f"apart; per read: {timing(k8_rec)}")
    extra = {"event_graph_search": ("streaming_append", k1_rec),
             "spline_shift_pooled": ("streaming_read", k3_rec),
             "pool_graph": ("streaming_read", k8_rec),
             "spline_fused_level0": ("streaming_dense_step", k2_rec),
             "upsample_rows": ("streaming_dense_step", k4_rec)}
    for r in records:
        if r["name"] in extra:
            r[extra[r["name"]][0]] = extra[r["name"]][1]
        if r["name"] in per_dense:
            r["streaming_dense_step_launches"] = per_dense[r["name"]]

    # ---- 9.4 detection read-out against the batch detector ----
    def det_batch(d, win, img):
        z = torch.zeros
        return EventBatch(
            pos=torch.cat(win)[None].to(d),
            polarity=ones.repeat(len(win))[None].to(d),
            valid=torch.ones((1, n_buf), dtype=torch.bool, device=d),
            rank=None, image=img[None].to(d), boxes=z(1, 2, 1, 4),
            box_present=z(1, 2, 1, dtype=torch.bool),
            box_labels=z(1, 1, dtype=torch.int32),
            bbox_mask=z(1, 1, dtype=torch.bool),
            bbox0_mask=z(1, 1, dtype=torch.bool), bbox=z(1, 1, 6))
    ev2 = SyntheticStream(cfg1, k, 1, "cpu")
    image2 = ev2.image()
    windows = {0: (fill, image),
               1: ([ev2.chunk() for _ in range(n_buf // k)], image2)}
    n_anchors = sum(nx * ny for nx, ny in bc1.grids[2:4])

    def no_sync_in_head(fn):
        """``fn()`` with every host-blocking CUDA call (a synchronise, a copy
        from pageable memory) inside the span ``detect/gnn_head`` raising
        (``torch.cuda.set_sync_debug_mode``)."""
        orig = sdet.span

        class Guarded:
            def __init__(self, name):
                self.span = orig(name)
                self.strict = name == "detect/gnn_head"

            def __enter__(self):
                self.span.__enter__()
                if self.strict:
                    torch.cuda.set_sync_debug_mode("error")

            def __exit__(self, *exc):
                if self.strict:
                    torch.cuda.set_sync_debug_mode("default")
                return self.span.__exit__(*exc)
        sdet.span = Guarded
        try:
            out = fn()
            torch.cuda.synchronize()
            return out
        finally:
            sdet.span = orig

    def check_head(read_det, dst):
        """The GNN head of one bf16 read: its K3 route (five launches a
        scale) against its plain spline convs (``gnn_head_scale_plain``)
        on the same graphs and operands, and no host-blocking call inside
        ``detect/gnn_head``, with either head; the plain head with one copy
        from pageable memory added raises there."""
        _, calls = recorded(mdet, "gnn_head_scale_forward",
                            lambda: no_sync_in_head(lambda: read_det(dst)))
        zero_counters()
        routed = [yh.gnn_head_scale_forward(*a, **kw) for a, kw in calls]
        torch.cuda.synchronize()
        per_head = read_counters({"spline_shift_pooled": 10},
                                 "the GNN head of one read")
        plain = [tuple(m.cpu() for m in yh.gnn_head_scale_plain(*a))
                 for a, _ in calls]
        route = mdet.gnn_head_scale_forward

        def plain_head(copies):
            def head(*a, **kw):
                for _ in range(copies):
                    torch.zeros(4).to("cuda")   # from pageable memory
                return yh.gnn_head_scale_plain(*a)
            mdet.gnn_head_scale_forward = head
            try:
                no_sync_in_head(lambda: read_det(dst))
                return False
            except RuntimeError:
                return True
            finally:
                mdet.gnn_head_scale_forward = route
        plain_blocks, copy_blocks = plain_head(0), plain_head(1)
        err = maps_err(routed, plain)
        if not (err <= HEAD_TOL and copy_blocks and not plain_blocks):
            raise AssertionError(f"GNN head: K3 route vs plain {err} of "
                                 f"scale (tolerance {HEAD_TOL}); blocking "
                                 f"in detect/gnn_head: the plain head "
                                 f"{plain_blocks}, with a pageable copy "
                                 f"{copy_blocks}")
        return (f"the GNN head's K3 route ({per_head} for both scales) vs "
                f"its plain spline convs max {err:.3g} of scale (tolerance "
                f"{HEAD_TOL}), no host-blocking call in detect/gnn_head, "
                f"nor in the plain head's (a pageable copy there raises)")

    det_ms = None
    for name, bcx, tol, seed in (("bfloat16", bc1, MAP_TOL, 0),
                                 ("bfloat16", bc1, MAP_TOL, 1),
                                 ("float32", bc1_32, F32_MAP_TOL, 0)):
        win, img = windows[seed]
        d_refresh, d_step = sdet.make_incremental_detector(
            detector, bcx, gsc, n_chunk=k, n_buf=n_buf)
        read_det = d_step.read_detections
        dst = sdet.update_image_detector(detector, inc.init_incremental_state(
            n_buf, bcx, EventADConfig(), device=dev), img.to(dev), bcx)
        for c in win[:-3]:
            dst = inc.insert_raw(dst, c.to(dev), ones.to(dev), k)
        dst = d_refresh(dst)
        for c in win[-3:]:
            prev = dst
            dst = d_step.append(dst, c.to(dev), ones.to(dev), k)
        zero_counters()
        ((dets, decoded), dec_calls), pp_calls = recorded(
            mdet, "postprocess", lambda: recorded(
                sdet, "decode_detections", lambda: read_det(dst)))
        nms_inputs[f"stream_{name}_{seed}"] = pp_calls[0]
        # launches/K3: the pooled levels' 8 and the GNN head's 10 in bf16
        seen = read_counters(
            {"spline_shift_pooled": 18, "bilinear_sample": 3, "pool_graph": 8,
             "postprocess": 1}
            if name == "bfloat16" else {"pool_graph": 8, "postprocess": 1},
            f"read_detections ({name})")
        head_note = (check_head(read_det, dst) if name == "bfloat16"
                     else "the head's plain spline convs")
        batch = det_batch(dev, win, img)
        with torch.no_grad():
            bmaps, _ = detector_maps(detector, batch, cfg1, bcx)
        _, bdecoded = detector_forward(detector, batch, cfg1, bcx)
        worst = maps_err(dec_calls[0][0][0], [tuple(m.cpu() for m in s)
                                              for s in bmaps])
        scale = bdecoded.abs().amax(dim=(0, 1)).clamp(min=1.0)
        dec_err = ((decoded - bdecoded).abs().amax(dim=(0, 1)) / scale) \
            .max().item()
        shapes = {n: tuple(x.shape) for n, x in dets.items()}
        # the step (append + read under one span) against the two calls:
        # the same bits in bf16; in f32 K8's atomic sums (the mean pooling
        # and the cell positions) have no fixed order, so two reads of one
        # state may differ in their last bits
        _, (sdets, sdecoded) = d_step(prev, win[-1].to(dev), ones.to(dev), k)
        if name == "bfloat16":
            step_same = torch.equal(sdecoded, decoded) and all(
                torch.equal(sdets[n], dets[n]) for n in dets)
            step_note = f"the step bit-identical to append + read: {step_same}"
        else:
            step_err = ((sdecoded - decoded).abs().amax(dim=(0, 1))
                        / scale).max().item()
            step_same = step_err <= tol
            step_note = (f"the step vs append + read: decoded max "
                         f"{step_err:.3g} of scale (K8's f32 atomics)")
        if not step_same:
            raise AssertionError(f"detection step ({name}) differs from "
                                 f"append + read_detections")
        if tuple(decoded.shape) != (1, n_anchors, 7) \
                or not bool(torch.isfinite(decoded).all()) \
                or shapes != dict(boxes=(1, 64, 4), scores=(1, 64),
                                  labels=(1, 64), mask=(1, 64)):
            raise AssertionError(f"read_detections ({name}): decoded "
                                 f"{tuple(decoded.shape)}, {shapes}")
        if det_ms is None:
            ts = []
            for _ in range(10):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                read_det(dst)
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            det_ms = sorted(ts)[len(ts) // 2]
        log(f"streaming detection ({name}, window of stream seed {seed}): "
            f"refresh + 3 appends + read_detections vs detector_forward at "
            f"batch 1 on the same window: maps max {worst:.3g} of scale, "
            f"decoded max {dec_err:.3g} of each column's scale (tolerance "
            f"{tol} for both); {int(dets['mask'].sum())} boxes kept of 64; "
            f"launches {seen}; {head_note}; {step_note}")
        if not (worst <= tol and dec_err <= tol):
            raise AssertionError(f"streaming detection ({name}, seed {seed})"
                                 f" differs from the batch detector")

    # ---- 9.5 times ----
    lat = latency_bench_incremental(model, cfg1, n_buf=n_buf, n_chunk=k,
                                    iters=STREAM_ITERS)
    dense = latency_bench(model, cfg1, n_buf=n_buf, n_chunk=k, iters=10)
    res = subprocess.run(
        [sys.executable, "-m", "eventad_tpu_torch.tools.profile_step",
         "streaming"], cwd=Path(__file__).resolve().parent,
        capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"profile_step streaming failed:\n"
                             f"{res.stderr[-3000:]}")
    prof = json.loads(res.stdout.strip().splitlines()[-1])
    n_traced = prof["n_traced"]
    times = dict(
        step_p50_ms=lat["p50_ms"], step_p99_ms=lat["p99_ms"],
        append_p50_ms=lat["append_p50_ms"], refresh_ms=lat["refresh_ms"],
        read_scores_p50_ms=lat["device_read_ms"],
        read_detections_p50_ms=det_ms,
        append_many_ms_per_chunk=lat["device_append_scan_ms"],
        step_many_ms_per_chunk=lat["device_step_scan_ms"],
        dense_step_p50_ms=dense["p50_ms"],
        traced_step_ms=prof["step_ms"],
        device_busy_ms_per_step=prof["device_busy_ms_per_step"],
        device_ops_per_step=prof["device_ops_per_step"],
        device_busy_share=1.0 - prof["device_idle_share"])
    log(f"streaming times on {smi} (bf16, {STREAM_ITERS} timed steps, one "
        f"synchronise a call; busy share from a trace of {n_traced} "
        f"steps in a fresh process): {json.dumps(times)}")
    return times


# phase 10: detector training (``train_detector``) at the operating point
TRAIN_DET_STEPS = 5
TRAIN_DET_LOSS_TOL = 1e-4   # relative, the f32 first step's losses vs CPU
# relative, the bf16 first step's loss on the card vs the CPU's: bf16
# rounds the detector's maps by up to 0.1 of their scale between the two
# (phase 8), and simOTA's discrete assignment passes that on to the loss
# (the reference's own bf16 test holds the first steps to 1 % of f32 at
# its small geometry, later ones to 25 %)
TRAIN_DET_BF16_BAND = 0.05
BN_STATE_TOL = 1e-3         # of each running statistic's scale (>= 1)
GRAD_SCALE_FLOOR = 1e-5     # a leaf's scale at least this: a bias that a
                            # batch-statistics BN follows has gradient 0
# A max-pooling cell whose two largest entries of a channel lie within
# NEAR_TIE of each other (relative) routes its cotangent to whichever the
# rounding makes the larger, and the card's convolutions round otherwise
# than the CPU's: the leaves behind such a cell (the backbone layers below
# it, the image remaps pooled into it and the ResNet trunk under them)
# move by a few hundredths of their scale when a route flips and are held
# to NEAR_TIE_TOL (as in tests/test_torch_train_detector.py), the others
# (the upper levels, the heads) to HEAD_GRAD_TOL.  The whole gradient's
# relative distance is printed beside them.
NEAR_TIE = 2e-5
NEAR_TIE_TOL = 5e-2
TRAIN_EVAL_BATCHES = 2


def detector_training_phase(dev, smi, records, counters):
    """Phase 10: detector training at full width (see the module
    docstring).  ``counters``: every kernel wrapper's launch counter by
    record name."""
    from eventad_tpu_torch.config import Config
    from eventad_tpu_torch.data.synthetic import (make_synthetic_batch,
                                                  synthetic_loader)
    from eventad_tpu_torch.models import backbone as bb
    from eventad_tpu_torch.models import detector as tdet
    from eventad_tpu_torch.ops import gather_window as gw
    from eventad_tpu_torch.ops.pooling import max_pool_margin
    from eventad_tpu_torch.test_detector import detection_metrics
    from eventad_tpu_torch.train_detector import (anchor_geometry,
                                                  make_detector_train_step)
    from eventad_tpu_torch.utils.ema import ema_init, ema_weights
    from eventad_tpu_torch.utils.schedules import (make_detector_optimizer,
                                                   yolox_schedule)

    counters = dict(counters, scatter_window_rows=gw.scatter_window_rows_cuda)
    cfg32 = Config(**dict(OP_POINT, compute_dtype="float32"))
    cfg16 = Config(**OP_POINT)
    cpu_batch = make_synthetic_batch(cfg32, seed=0,
                                     boxes_per_item=BOXES_PER_ITEM)
    batch = cpu_batch.to(dev)

    def trainer(cfg, device, total_steps):
        """A detector from seed 0 with the root script's optimizer (its
        schedule warming up over one step), EMA and training step."""
        det, bcx = tdet.init_detector(
            cfg, torch.Generator().manual_seed(0), device)
        opt = make_detector_optimizer(
            det.parameters(), cfg.optimizer,
            yolox_schedule(cfg.lr, warmup_steps=1, total_steps=total_steps),
            cfg.weight_decay, cfg.clip)
        step = make_detector_train_step(det, cfg, bcx, opt,
                                        anchor_geometry(bcx, device))
        return det, bcx, opt, step, ema_init(det.parameters())

    def first_step(cfg, device, b):
        """One step; the gradients before the clip scales them, the
        losses, the detector, and (on the card) the poolings' inputs."""
        det, bcx, opt, step, ema = trainer(cfg, device, TRAIN_DET_STEPS)
        grads, pools, update = [], [], opt.step

        def keep():
            grads.extend(p.grad.detach().clone() if p.grad is not None
                         else torch.zeros_like(p) for p in opt.params)
            update()
        opt.step = keep
        pool_graph = bb.pool_graph

        def recorded_pool(x, pos, nbr, nbr_mask, node_mask, batch_ids,
                          **kw):
            pools.append((x.detach(), pos, node_mask, batch_ids, kw))
            return pool_graph(x, pos, nbr, nbr_mask, node_mask, batch_ids,
                              **kw)
        bb.pool_graph = recorded_pool
        try:
            ema, losses = step(b, ema)
        finally:
            bb.pool_graph = pool_graph
        return det, grads, {k: float(v) for k, v in losses.items()}, pools

    def refuse_nms(*a, **kw):
        raise AssertionError("a training step ran the NMS")
    postprocess, tdet.postprocess = tdet.postprocess, refuse_nms
    try:
        # ---- 10.1 the first step against the port's CPU run ----
        t0 = time.perf_counter()
        det_c, grads_c, loss_c, _ = first_step(cfg32, "cpu", cpu_batch)
        cpu_s = time.perf_counter() - t0
        det_g, grads_g, loss_g, pools = first_step(cfg32, dev, batch)
        torch.cuda.synchronize()
        for k, v in loss_c.items():
            if not abs(loss_g[k] - v) <= TRAIN_DET_LOSS_TOL * max(abs(v),
                                                                  1.0):
                raise AssertionError(f"detector training: first-step {k} "
                                     f"{loss_g[k]} on the card, {v} on "
                                     f"the CPU")
        tied = [lv for lv, (x, pos, nm, bid, kw) in enumerate(pools, 1)
                if kw["aggr"] == "max" and max_pool_margin(
                    x, pos, nm, bid, grid=kw["grid"],
                    batch_size=kw["batch_size"]) < NEAR_TIE]
        top = max(tied, default=0)
        behind = tuple(f"dagr.backbone.layers.{i}." for i in range(top)) \
            + tuple(f"dagr.cnn.feature_{wb}.{i}" for i in range(top + 1)
                    for wb in "wb") \
            + (("dagr.cnn.conv1", "dagr.cnn.bn1", "dagr.cnn.layers.")
               if top else ())
        names = [n for n, _ in det_g.named_parameters()]
        worst = {False: (0.0, ""), True: (0.0, "")}
        diff2 = norm2 = 0.0
        for name, g, c in zip(names, grads_g, grads_c):
            c = c.to(dev)
            err = ((g - c).abs().max() / max(c.abs().max().item(),
                                             GRAD_SCALE_FLOOR)).item()
            loose = name.startswith(behind)
            worst[loose] = max(worst[loose], (err, name))
            diff2 += float(((g - c) ** 2).sum())
            norm2 += float((c ** 2).sum())
        log(f"detector training: first f32 step, gradients: strict worst "
            f"{worst[False]}, behind near ties at {tied} worst "
            f"{worst[True]}, whole {(diff2 / norm2) ** 0.5:.3g} of its norm")
        if not worst[False][0] <= HEAD_GRAD_TOL \
                or not worst[True][0] <= NEAR_TIE_TOL:
            raise AssertionError(f"detector training: first-step gradients "
                                 f"differ from the CPU's: {worst}")
        bn_err = max((((a - b.to(dev)).abs().max()
                       / max(b.abs().max().item(), 1.0)).item(), n)
                     for (n, a), b in zip(det_g.named_buffers(),
                                          det_c.buffers()))
        if not bn_err[0] <= BN_STATE_TOL:
            raise AssertionError(f"detector training: running statistics "
                                 f"after one step differ: {bn_err}")
        det16_c, _, loss16_c, _ = first_step(cfg16, "cpu", cpu_batch)
        det16_g, _, loss16_g, _ = first_step(cfg16, dev, batch)
        band16 = abs(loss16_g["total"] - loss16_c["total"]) \
            / abs(loss16_c["total"])
        log(f"detector training: first bfloat16 step, losses on the card "
            f"{loss16_g}, on the CPU {loss16_c}")
        if not band16 <= TRAIN_DET_BF16_BAND:
            raise AssertionError(f"detector training: bf16 first-step loss "
                                 f"{loss16_g['total']} on the card, "
                                 f"{loss16_c['total']} on the CPU")
        log(f"detector training: first step (float32) on the card vs the "
            f"CPU (CPU step {cpu_s:.1f} s): losses {loss_g} vs {loss_c} "
            f"(tolerance {TRAIN_DET_LOSS_TOL} relative); "
            f"{len(grads_g)} gradient leaves, worst {worst[False][0]:.3g} "
            f"of its scale ({worst[False][1]}; tolerance {HEAD_GRAD_TOL}); "
            f"max-pooling near ties (< {NEAR_TIE}) at levels {tied}, the "
            f"{sum(n.startswith(behind) for n in names)} leaves behind them "
            f"worst {worst[True][0]:.3g} ({worst[True][1]}; tolerance "
            f"{NEAR_TIE_TOL}); the whole gradient "
            f"{(diff2 / norm2) ** 0.5:.3g} of its norm; running statistics "
            f"worst {bn_err[0]:.3g} of scale ({bn_err[1]}; tolerance "
            f"{BN_STATE_TOL}); bfloat16 loss "
            f"{loss16_g['total']:.6g} vs the CPU's {loss16_c['total']:.6g} "
            f"({band16:.3g} relative, band {TRAIN_DET_BF16_BAND})")
        del det_c, grads_c, grads_g, pools, det16_c, det16_g

        # ---- 10.2 launches of one f32 step; K6b at its shapes ----
        det, bc32, opt, step, ema = trainer(cfg32, dev, TRAIN_DET_STEPS)
        ema, _ = step(batch, ema)
        # the backward's scatter calls, recorded at their call site
        recorded, dispatch = [], gw.scatter_window_rows

        def recorded_scatter(*a, **kw):
            recorded.append((a, kw))
            return dispatch(*a, **kw)
        for fn in counters.values():
            fn.launches = 0
        gw.scatter_window_rows = recorded_scatter
        try:
            ema, _ = step(batch, ema)
            torch.cuda.synchronize()
        finally:
            gw.scatter_window_rows = dispatch
        step_seen = {n: fn.launches for n, fn in counters.items()
                     if fn.launches}
        expect = dict(event_graph_search=1, gather_window_rows=2,
                      scatter_window_rows=4)
        if step_seen != expect:
            raise AssertionError(f"one f32 training step launched "
                                 f"{step_seen}, expected {expect}")
        del det, opt, step, ema
    finally:
        tdet.postprocess = postprocess

    k6b = dict(ms=0.0, launch_ms=0.0, plain_ms=0.0, library_ms=0.0,
               library_launch_ms=0.0, max_abs_err=0.0)
    k6b_bytes = k6b_ops = 0
    widths = []
    scatter = gw.scatter_window_rows_cuda
    for (g, nbr, mask, n_src), kw in recorded:
        c = g.shape[2]
        widths.append(c)
        got = scatter(g, nbr, mask, n_src, **kw)
        if not torch.equal(got, scatter(g, nbr, mask, n_src, **kw)):
            raise AssertionError("scatter_window_rows: two runs differ at "
                                 "the training step's shapes")
        want = gw.scatter_window_rows_plain(g, nbr, mask, n_src)
        err = (got - want).abs().max().item()
        if not err <= SCATTER_TOL * (want.abs().max().item() + 1e-12):
            raise AssertionError(f"scatter_window_rows at the training "
                                 f"step's shapes: max abs err {err}")
        k6b["max_abs_err"] = max(k6b["max_abs_err"], err)
        k6b["ms"] += median_ms(lambda: scatter(g, nbr, mask, n_src, **kw))
        k6b["launch_ms"] += launch_ms(gw, lambda: scatter(g, nbr, mask,
                                                          n_src, **kw))
        k6b["plain_ms"] += median_ms(
            lambda: gw.scatter_window_rows_plain(g, nbr, mask, n_src))
        flat_idx = torch.where(mask, nbr, 0).long().reshape(-1)
        gm = torch.where(mask[..., None], g, 0.0).reshape(-1, c)

        def index_add():
            return torch.zeros((n_src, c), device=dev).index_add_(
                0, flat_idx, gm)
        k6b["library_ms"] += median_ms(index_add)
        k6b["library_launch_ms"] += graph_ms(index_add)
        edges = int(mask.sum())
        k6b_bytes += (tensor_bytes(mask) + edges * nbr.element_size()
                      + edges * c * g.element_size()
                      + n_src * c * got.element_size())
        k6b_ops += edges * c
        del gm, flat_idx
    k6b["bound_ms"], k6b["bound_by"] = bound(k6b_bytes, k6b_ops, PEAK_F32)
    shapes = [tuple(a[0].shape) for a, _ in recorded]
    log(f"detector training: one f32 step launched {step_seen} (no other "
        f"kernel, no NMS); K6b at the step's cotangents {shapes} "
        f"(level-0 widths {widths}, at most 128): bit-identical twice, max "
        f"abs err vs index_add_ {k6b['max_abs_err']:.3g}; kernel "
        f"{k6b['ms']:.4f} ms (launches alone {k6b['launch_ms']:.4f}), "
        f"plain {k6b['plain_ms']:.4f}, index_add_ {k6b['library_ms']:.4f} "
        f"(alone {k6b['library_launch_ms']:.4f}), bound "
        f"{k6b['bound_ms']:.5f} ms by {k6b['bound_by']} ({k6b_bytes} bytes, "
        f"{k6b_ops} additions) for both calls")
    del recorded

    # ---- 10.3 five steps a dtype on one batch, timed ----
    times = {}
    for cfg in (cfg32, cfg16):
        dt = cfg.compute_dtype
        det, bcx, opt, step, ema = trainer(cfg, dev, TRAIN_DET_STEPS)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        losses, ts, scatters = [], [], []

        def scatter_widths(g, *a, **kw):
            scatters.append((g.shape[-1], g.dtype))
            return dispatch(g, *a, **kw)
        for i in range(TRAIN_DET_STEPS):
            gw.scatter_window_rows = scatter_widths if i == 0 else dispatch
            t0 = time.perf_counter()
            try:
                ema, out = step(batch, ema)
                torch.cuda.synchronize()
            finally:
                gw.scatter_window_rows = dispatch
            ts.append((time.perf_counter() - t0) * 1e3)
            losses.append(float(out["total"]))
        peak = torch.cuda.max_memory_allocated()
        if len(scatters) != 2 or max(c for c, _ in scatters) > 128:
            raise AssertionError(f"detector training ({dt}): K6b calls "
                                 f"(width, dtype) {scatters}")
        if not (all(x == x and abs(x) != float("inf") for x in losses)
                and losses[-1] < losses[0]):
            raise AssertionError(f"detector training ({dt}): losses "
                                 f"{losses} not finite and falling")
        if ema.updates != TRAIN_DET_STEPS or opt.count != TRAIN_DET_STEPS:
            raise AssertionError(f"EMA updates {ema.updates}, optimizer "
                                 f"updates {opt.count}")
        kept = [t.dtype for t in list(det.parameters())
                + list(det.buffers()) + ema.params]
        if any(t != torch.float32 for t in kept):
            raise AssertionError(f"detector training ({dt}): master "
                                 f"weights, EMA or BN statistics not f32")
        med = sorted(ts)[len(ts) // 2]
        times[dt] = dict(losses=losses, step_ms=med, step_ms_all=ts,
                         items_per_sec=cfg.batch_size / med * 1e3,
                         peak_memory_bytes=peak,
                         step_memory_bytes=peak - held)
        log(f"detector training ({dt}): {TRAIN_DET_STEPS} steps on one "
            f"batch, losses {losses} (falling); K6b's cotangents (width, "
            f"dtype) {scatters}; EMA updates {ema.updates}; "
            f"master weights, EMA and BN statistics f32; step ms {ts}")

        # ---- 10.4 the EMA weights evaluated (mAP, not gated) ----
        if dt == "bfloat16":
            loader = synthetic_loader(cfg, TRAIN_EVAL_BATCHES, seed=100,
                                      boxes_per_item=BOXES_PER_ITEM)
            for fn in counters.values():
                fn.launches = 0
            t0 = time.perf_counter()
            with torch.no_grad(), ema_weights(det.parameters(), ema):
                metrics = detection_metrics(det, loader, cfg, bcx, dev)
            eval_s = time.perf_counter() - t0
            seen = {n: fn.launches for n, fn in counters.items()
                    if fn.launches}
            n = TRAIN_EVAL_BATCHES
            expect = dict(event_graph_search=n, spline_fused_level0=2 * n,
                          spline_shift_pooled=18 * n, upsample_rows=n,
                          bilinear_sample=3 * n, pool_graph=8 * n,
                          postprocess=n)
            if seen != expect:
                raise AssertionError(f"the bf16 EMA evaluation launched "
                                     f"{seen}, expected {expect}")
            log(f"detector training: the EMA weights (bf16 eval, live "
                f"running statistics) over {n} batches: mAP "
                f"{metrics['mAP']:.4f}, mAP@50 {metrics['mAP_50']:.4f} "
                f"({eval_s:.1f} s); launches {seen}")
        del det, opt, step, ema

    # ---- 10.5 the device's share, a fresh process per dtype ----
    for dt in ("float32", "bfloat16"):
        res = subprocess.run(
            [sys.executable, "-m", "eventad_tpu_torch.tools.profile_step",
             "detector_train", dt], cwd=Path(__file__).resolve().parent,
            capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise AssertionError(f"profile_step detector_train {dt} failed:"
                                 f"\n{res.stderr[-3000:]}")
        prof = json.loads(res.stdout.strip().splitlines()[-1])
        times[dt].update(
            profiled_step_ms=prof["step_ms"],
            profiled_peak_memory_bytes=prof["peak_memory_bytes"],
            device_busy_ms_per_step=prof["device_busy_ms_per_step"],
            device_ops_per_step=prof["device_ops_per_step"],
            device_idle_share=prof["device_idle_share"],
            top_kernels=prof["top_kernels"][:5])
    log(f"detector training times on {smi} (batch {cfg32.batch_size}, "
        f"{cfg32.event_buckets[0]} events an item, {cfg32.img_net}; step ms "
        f"the median of {TRAIN_DET_STEPS}, one "
        f"synchronise a step; device figures from a trace of 3 steps in a "
        f"fresh process): {json.dumps(times)}")

    by_name = {r["name"]: r for r in records}
    train_launches = dict(event_graph_search=1, gather_window_rows=2,
                          scatter_window_rows=4)
    for name, r in by_name.items():
        r["train_step_launches"] = train_launches.get(name, 0)
    r = by_name["scatter_window_rows"]
    # the level-0 gradient check of phase 5 keeps its figures as check_*;
    # the record's own are the training step's, the kernel's system path
    for key in ("ms", "launch_ms", "plain_ms", "library_ms",
                "library_launch_ms", "bound_ms", "bound_by", "max_abs_err"):
        r["check_" + key] = r[key]
        r[key] = k6b[key]
    r["launches"] = step_seen["scatter_window_rows"]
    return times


# phase 11: the host data path feeding the card.  Sequences made in memory by
# the fixture's array generator at the operating point (frames rendered at
# model size), cut into Items as SequenceDataset cuts them from files, and
# batched by the Loader three ways
LOADER_SEQUENCES = 6      # x 8 items: 48 items, 8 batches of 6
LOADER_FRAMES = 9
LOADER_EVENTS = 16_000    # a window holds ~16 000 events, an anomalous
                          # sequence's after its TOA ~24 000 (truncated)
LOADER_WORKERS = 4        # the JAX package's num_workers default
LOADER_MODES = (("serial", dict(prefetch=0, num_workers=0)),
                ("thread", dict(num_workers=0)),
                ("processes", dict(num_workers=LOADER_WORKERS)))
# the fixture of tests/test_parity_fixture.py, evaluated on the card and on
# the CPU from the same weights
PARITY_CFG = dict(width=96, height=72, scale=1, batch_size=2,
                  use_image=False, event_buckets=(4096,), graph_lookback=512,
                  num_workers=0, seed=7)
PARITY_METRIC_TOL = 1e-3  # AUC, AUC_unadjusted, AP, AUC-Frame, absolute
PARITY_SCORE_TOL = 1e-3   # score_mean, score_max, relative


def percentile(values, q):
    v = sorted(values)
    return v[min(len(v) - 1, int(q * len(v)))]


def loader_phase(dev, smi, cfg, model, cpu_model, bc, mc, gsc, records,
                 zero_counters, read_counters):
    """Phase 11: the Loader feeding K1-K4, and the fixture's metrics on the
    card (see the module docstring)."""
    from eventad_tpu_torch.config import Config
    from eventad_tpu_torch.data.batching import Loader, collate
    from eventad_tpu_torch.data.dataset import MemoryDataset
    from eventad_tpu_torch.data.fixtures import (fixture_sequences,
                                                 make_sequence)
    from eventad_tpu_torch.models.dagr import init_model, model_forward
    from eventad_tpu_torch.native import queue_ranks, queue_ranks_plain
    from eventad_tpu_torch.parallel.train_step import (make_optimizer,
                                                       make_train_fns)
    from eventad_tpu_torch.parity import _train_fixture_head, fixture_metrics
    from eventad_tpu_torch.utils.evaluation import (
        calculate_bbox_metrics, calculate_frame_metrics,
        calculate_response_metrics, calculate_tta_metrics)
    from eventad_tpu_torch.utils.fps import measure_fps
    from eventad_tpu_torch.utils.predict import collect_predictions

    # ---- 11.1 items at the operating point ----
    t0 = time.perf_counter()
    seqs = [make_sequence(f"loader_{i:02d}", cfg, n_frames=LOADER_FRAMES,
                          n_objects=BOXES_PER_ITEM, anomalous=(i % 3 == 0),
                          toa_frame=6, seed=100 + i,
                          events_per_window=LOADER_EVENTS, frame_scale=1)
            for i in range(LOADER_SEQUENCES)]
    ds = MemoryDataset(cfg, seqs)
    items = [ds[i] for i in range(len(ds))]
    n_ev = [len(it.events["t"]) for it in items]
    n_cap = cfg.event_buckets[-1]
    over = sum(n > n_cap for n in n_ev)
    log(f"loader items: {len(items)} from {len(seqs)} sequences of "
        f"{LOADER_FRAMES} frames, {cfg.model_width}x{cfg.model_height}, "
        f"{BOXES_PER_ITEM} boxes, made and cut in "
        f"{time.perf_counter() - t0:.2f} s; events per item min {min(n_ev)}"
        f" p10 {percentile(n_ev, 0.1)} p50 {percentile(n_ev, 0.5)} p90 "
        f"{percentile(n_ev, 0.9)} max {max(n_ev)}; {over} items over the "
        f"{n_cap} bucket")
    if not 0 < over < len(items) // 2 \
            or abs(percentile(n_ev, 0.5) - n_cap) > 0.1 * n_cap:
        raise AssertionError("the items do not sit at the 16 384 bucket "
                             "with a few over it")

    # ---- 11.2 the Loader three ways ----
    loaders, runs, alone = {}, {}, {}
    for name, kw in LOADER_MODES:
        ld = Loader(ds, cfg, shuffle=False, **kw)
        if ld.mode() != name:
            raise AssertionError(f"{name}: the Loader chose {ld.mode()}")
        loaders[name] = ld
        t0 = time.perf_counter()
        runs[name] = list(ld)
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        n = sum(1 for _ in ld)
        alone[name] = n / (time.perf_counter() - t0)
        log(f"loader ({name}): {len(runs[name])} batches, first epoch "
            f"{first:.3f} s (a pool's start included), then "
            f"{alone[name]:.2f} batches/s alone")
    ref = runs["serial"]
    for name in ("thread", "processes"):
        for (b, m), (rb, rm) in zip(runs[name], ref, strict=True):
            if m != rm or not all(torch.equal(x, y) for x, y in zip(b, rb)):
                raise AssertionError(f"loader ({name}): a batch differs "
                                     f"from the serial one")
    truncated = sum(m.truncated_events for _, m in ref)
    if not truncated > 0 or any(ld.truncated_events != 2 * truncated
                                for ld in loaders.values()):
        raise AssertionError("the truncation counter disagrees")
    log(f"loader: the three modes give the same {len(ref)} batches bit for "
        f"bit ({LOADER_WORKERS} spawned workers with no CUDA device); "
        f"{truncated} events truncated an epoch (Loader.truncated_events)")
    bsz = cfg.batch_size
    chunks = [items[i:i + bsz] for i in range(0, len(items), bsz)]
    collate_ms, ranks_ms, plain_ranks_ms = [], [], []
    for _ in range(3):
        for c in chunks:
            t0 = time.perf_counter()
            collate(c, cfg)
            collate_ms.append((time.perf_counter() - t0) * 1e3)
            # its queue ranks (the C++ of native/evio.cpp), and the numpy
            # plain version on the same events, which they must equal
            cols = []
            for it in c:
                n = min(len(it.events["t"]), n_cap)
                cols.append((it.events["x"][-n:], it.events["y"][-n:]))
            t0 = time.perf_counter()
            got = [queue_ranks(x, y, cfg.model_width, cfg.model_height)
                   for x, y in cols]
            ranks_ms.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            want = [queue_ranks_plain(x, y, cfg.model_width,
                                      cfg.model_height) for x, y in cols]
            plain_ranks_ms.append((time.perf_counter() - t0) * 1e3)
            if not all(a.shape == b.shape and bool((a == b).all())
                       for a, b in zip(got, want)):
                raise AssertionError("queue_ranks (C++) differs from its "
                                     "plain version on a loader batch")
    log(f"queue_ranks (C++) equal to the numpy plain version on "
        f"{len(collate_ms) * bsz} items ({len(chunks)} batches, 3 passes)")

    # ---- 11.3 the batches reach the kernels ----
    fns = make_train_fns(model, bc, mc, gsc, make_optimizer(
        model.head.parameters(), cfg.learning_rate, cfg.weight_decay,
        cfg.grad_clip), dev)
    first_batch = ref[0][0]
    zero_counters()
    logits, valid = fns.eval_step(first_batch)[:2]
    torch.cuda.synchronize()
    per_batch = read_counters(dict(event_graph_search=1,
                                   spline_fused_level0=2,
                                   spline_shift_pooled=8, upsample_rows=1,
                                   bilinear_sample=3, pool_graph=8),
                              "a loader batch's eval_step")
    for r in records:
        r["loader_batch_launches"] = per_batch.get(r["name"], 0)
    t0 = time.perf_counter()
    cpu_out = model_forward(cpu_model, first_batch, bc, mc, gsc)
    v = cpu_out.valid
    if not torch.equal(v, valid.cpu()) \
            or not bool(torch.isfinite(logits).all()):
        raise AssertionError("loader batch 0: valid slots differ from the "
                             "CPU, or logits not finite")
    d = (cpu_out.logits[v] - logits.cpu()[v]).abs().max().item()
    log(f"loader batch 0: GPU vs CPU logits max abs diff {d:.3g} over "
        f"{int(v.sum())} valid slots (tolerance {LOGIT_TOL}); CPU forward "
        f"{time.perf_counter() - t0:.1f} s; launches {per_batch}")
    if not d < LOGIT_TOL:
        raise AssertionError(f"loader batch 0: logits differ by {d}")

    def consume(loader):
        """Each batch through eval_step, synchronised: per batch the wait
        on the loader, the whole step (wait, copy, forward) and the
        boxes of both frames."""
        waits, steps, boxes = [], [], []
        it = iter(loader)
        while True:
            t0 = time.perf_counter()
            try:
                batch, _meta = next(it)
            except StopIteration:
                break
            t1 = time.perf_counter()
            fns.eval_step(batch)
            torch.cuda.synchronize()
            waits.append(t1 - t0)
            steps.append(time.perf_counter() - t0)
            boxes.append(int(batch.box_present.sum()))
        return waits, steps, boxes

    times = {"card": smi, "collate_ms_p50": percentile(collate_ms, 0.5),
             "collate_ms_p90": percentile(collate_ms, 0.9),
             "queue_ranks_ms_p50": percentile(ranks_ms, 0.5),
             "queue_ranks_plain_ms_p50": percentile(plain_ranks_ms, 0.5),
             "batches": len(ref)}
    nb = len(ref)
    zero_counters()
    for name, _ in LOADER_MODES:
        waits, steps, boxes = consume(loaders[name])
        times[name] = dict(
            batches_per_s_alone=alone[name],
            wait_ms_p50=percentile(waits, 0.5) * 1e3,
            wait_ms_mean=sum(waits) / len(waits) * 1e3,
            step_ms_p50=percentile(steps, 0.5) * 1e3,
            sync_bboxes_per_s=sum(boxes) / len(boxes)
            / percentile(steps, 0.5))
    read_counters({k: 3 * nb * n for k, n in per_batch.items()},
                  "three loader epochs")
    staged = [b.to(dev) for b, _ in ref]
    fwd = []
    for b in staged:
        t0 = time.perf_counter()
        fns.eval_step(b)
        torch.cuda.synchronize()
        fwd.append(time.perf_counter() - t0)
    boxes = [int(b.box_present.sum()) for b in staged]
    times["without_loader"] = dict(
        step_ms_p50=percentile(fwd, 0.5) * 1e3,
        sync_bboxes_per_s=sum(boxes) / len(boxes) / percentile(fwd, 0.5))
    del staged
    log(f"loader times on {smi}: collate {times['collate_ms_p50']:.2f} ms "
        f"p50, {times['collate_ms_p90']:.2f} p90 a batch (its queue ranks "
        f"{times['queue_ranks_ms_p50']:.3f} ms p50 in C++, "
        f"{times['queue_ranks_plain_ms_p50']:.2f} by the numpy plain "
        f"version); " + "; ".join(
            f"{name} {t['batches_per_s_alone']:.2f} batches/s alone, waits "
            f"{t['wait_ms_p50']:.2f} ms p50 a batch, sync bboxes/s "
            f"{t['sync_bboxes_per_s']:.1f} with the loader in the loop"
            for name, t in ((n, times[n]) for n, _ in LOADER_MODES))
        + f"; without it (the same batches on the card) "
        f"{times['without_loader']['sync_bboxes_per_s']:.1f} bboxes/s")

    # ---- 11.4 the test pipeline with the loader in the loop ----
    def forward(batch):
        logits, valid, labels, _loss, _nv = fns.eval_step(batch)
        return (logits.cpu().numpy(), valid.cpu().numpy(),
                labels.cpu().numpy())
    toa = {s["name"]: s["toa"] for s in seqs if s["toa"] is not None}
    results = collect_predictions(forward, loaders["processes"],
                                  threshold=cfg.threshold)
    bbox = calculate_bbox_metrics(results["all_labels"],
                                  results["all_scores"])
    frame = calculate_frame_metrics(results["frame_data"])
    tta = calculate_tta_metrics(results["video_predictions"],
                                results["video_first_anomaly"], toa)
    fps = measure_fps(fns.eval_step, loaders["processes"], warmup_batches=2,
                      num_batches=nb)
    response = calculate_response_metrics(results["video_predictions"],
                                          fps=fps["fps"])
    for ld in loaders.values():
        ld.close()
    log(f"test pipeline over the processes loader (random weights, not "
        f"gated): {len(results['all_scores'])} scored boxes; AUC "
        f"{bbox['auc']:.4f} AP {bbox['ap']:.4f} AUC-Frame "
        f"{frame['auc_frame']:.4f} mTTA {tta.get('mtta')} mRESPONSE "
        f"{response.get('mresponse')} FPS {fps['fps']:.1f}")
    if not (fps["fps"] > 0 and all(x == x for x in (
            bbox["auc"], bbox["ap"], frame["auc_frame"]))):
        raise AssertionError("the test pipeline's metrics are not finite")

    # ---- 11.5 the fixture's metrics on the card and on the CPU ----
    pcfg = Config(**PARITY_CFG)
    groups = {}
    for g, s in fixture_sequences(pcfg):
        groups.setdefault(g, []).append(s)
    ptoa = {s["name"]: s["toa"] for s in groups["val"]
            if s["toa"] is not None}
    train_ds = MemoryDataset(pcfg, groups[pcfg.train_split])
    val_ds = MemoryDataset(pcfg, groups["val"])

    def fixture_loader(d):
        return Loader(d, pcfg, shuffle=False)
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(pcfg.seed)
    cpu_m, bcp, mcp = init_model(pcfg, gen, cpu)
    t0 = time.perf_counter()
    cpu_losses = _train_fixture_head(pcfg, cpu_m, bcp, mcp,
                                     fixture_loader(train_ds), cpu)
    t_train = time.perf_counter() - t0
    gpu_m, _, _ = init_model(pcfg, torch.Generator().manual_seed(0), dev)
    gpu_m.load_state_dict(cpu_m.state_dict())
    t0 = time.perf_counter()
    m_cpu = fixture_metrics(pcfg, cpu_m, bcp, mcp, fixture_loader(val_ds),
                            ptoa, cpu)[0]
    t_cpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    m_gpu = fixture_metrics(pcfg, gpu_m, bcp, mcp, fixture_loader(val_ds),
                            ptoa, dev)[0]
    t_gpu = time.perf_counter() - t0
    diffs = {k: m_gpu[k] - m_cpu[k] for k in m_cpu}
    log(f"fixture parity ({pcfg.model_width}x{pcfg.model_height}, batch "
        f"{pcfg.batch_size}, {pcfg.event_buckets[0]} bucket, lookback "
        f"{pcfg.graph_lookback}, seed {pcfg.seed}, f32): head trained on "
        f"the CPU, {len(cpu_losses)} steps in {t_train:.1f} s (per-box "
        f"loss {float(cpu_losses[0]):.4f} -> {float(cpu_losses[-1]):.4f}); "
        f"CPU {m_cpu} ({t_cpu:.1f} s); card {m_gpu} ({t_gpu:.1f} s); card "
        f"- CPU {diffs}")
    for k in ("AUC", "AUC_unadjusted", "AP", "AUC-Frame"):
        if not abs(diffs[k]) <= PARITY_METRIC_TOL:
            raise AssertionError(f"fixture {k}: card {m_gpu[k]} vs CPU "
                                 f"{m_cpu[k]}")
    for k in ("mTTA", "mRESPONSE"):
        if m_gpu[k] != m_cpu[k]:
            raise AssertionError(f"fixture {k}: card {m_gpu[k]} vs CPU "
                                 f"{m_cpu[k]}")
    for k in ("score_mean", "score_max"):
        if not abs(diffs[k]) <= PARITY_SCORE_TOL * abs(m_cpu[k]):
            raise AssertionError(f"fixture {k}: card {m_gpu[k]} vs CPU "
                                 f"{m_cpu[k]}")
    card_m, _, _ = init_model(pcfg, torch.Generator().manual_seed(
        pcfg.seed), dev)
    t0 = time.perf_counter()
    card_losses = _train_fixture_head(pcfg, card_m, bcp, mcp,
                                      fixture_loader(train_ds), dev)
    t_card = time.perf_counter() - t0
    m_card = fixture_metrics(pcfg, card_m, bcp, mcp, fixture_loader(val_ds),
                             ptoa, dev)[0]
    head, tail = card_losses[:50].mean(), card_losses[-50:].mean()
    log(f"fixture head trained on the card: {len(card_losses)} steps in "
        f"{t_card:.1f} s, per-box loss of the first 50 steps "
        f"{float(head):.4f}, of the last 50 {float(tail):.4f}; metrics "
        f"{m_card}")
    if not (tail < head and all(v == v and abs(v) < float("inf")
                                for v in m_card.values())):
        raise AssertionError("the card-trained head's loss did not fall, "
                             "or a metric is not finite")
    times["fixture"] = dict(card_minus_cpu=diffs, cpu=m_cpu, card=m_gpu,
                            card_trained=m_card)
    read = [m for m in ("h5py", "yaml", "cv2") if m in sys.modules]
    if read:
        raise AssertionError(f"phase 11 imported {read}")
    print(json.dumps({"loader_times": times}), flush=True)
    return times


# phase 12: the ``bench`` module's records, and the parallel paths of
# ``parallel/`` at world size 1 under NCCL against the same work without a
# process group (one card: NCCL refuses two ranks on one card)
# the DP head step against the plain one, relative: the loss, and each head
# leaf (its gradient, and its value after the update) of that leaf's
# scale.  The steps run under torch.use_deterministic_algorithms: the
# feature path's index_add_ (the pooled cells' mean positions,
# ops/pooling.py) sums with CUDA atomics in an order that varies from run
# to run, ~1e-7 of the features, which Adam's first update turns into up
# to the rate where a gradient is small
DP_LOSS_TOL = 1e-6
DP_LEAF_TOL = 1e-6
DP_EVAL_TOL = 1e-6        # of the logits' scale
DP_DET_LOSS_TOL = 1e-5    # relative, the 1x1 detector step's losses
SEQ_SP_TOL = 1e-5         # of each level's scale, f32 (the JAX tool's bound)
SEQ_SP_BF16_TOL = KERNEL_TOL
DP_TIMED_STEPS = 5


def parallel_phase(dev, smi, cfg, model, bc, mc, gsc, records, counters):
    """Phase 12 (see the module docstring).  ``model`` is the operating
    point's seed-0 model (the bench's weights; its head moves)."""
    import copy

    import torch.distributed as dist

    from eventad_tpu_torch.data.synthetic import make_synthetic_batch
    from eventad_tpu_torch.models import detector as tdet
    from eventad_tpu_torch.ops import gather_window as gw
    from eventad_tpu_torch.parallel.mesh import (init_distributed,
                                                 make_mesh, shard_batch)
    from eventad_tpu_torch.parallel.seq_shard import seq_sharded_features
    from eventad_tpu_torch.parallel.sharding import (shard_params,
                                                     sharded_init)
    from eventad_tpu_torch.parallel.train_step import (make_optimizer,
                                                       make_train_fns)
    from eventad_tpu_torch.streaming import incremental as inc
    from eventad_tpu_torch.train_detector import (anchor_geometry,
                                                  make_detector_train_step)
    from eventad_tpu_torch.utils.ema import ema_init
    from eventad_tpu_torch.utils.schedules import make_detector_optimizer

    counters = dict(counters, gather_window_rows=gw.gather_window_rows_cuda,
                    scatter_window_rows=gw.scatter_window_rows_cuda)

    def counted(fn):
        for c in counters.values():
            c.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {n: c.launches for n, c in counters.items()
                     if c.launches}

    def same_launches(what, plain, par, need):
        log(f"{what}: launches without a group {plain}, on the mesh {par}")
        if plain != par or not set(need) <= set(par):
            raise AssertionError(f"{what}: launches {par} on the mesh, "
                                 f"{plain} without a group (needs {need})")

    # (12.1, the bench module's records, runs in phase 13, in a process of
    # its own: its profiler trace is to be taken early in a process)

    # ---- 12.2 a world-size-1 NCCL group through a FileStore ----
    store = Path(tempfile.mkdtemp()) / "store"
    init_distributed(dev, store_path=store, rank=0, world_size=1)
    log(f"process group: {dist.get_backend()}, world size "
        f"{dist.get_world_size()}")
    try:
        mesh = make_mesh("1")
        bc32 = bc._replace(compute_dtype="float32")
        batch1 = make_synthetic_batch(cfg, seed=1,
                                      boxes_per_item=BOXES_PER_ITEM).to(dev)
        plain_m = copy.deepcopy(model)
        dp_m = copy.deepcopy(model)

        def fns(m, bcx, mesh=None):
            opt = make_optimizer(m.head.parameters(), cfg.learning_rate,
                                 cfg.weight_decay, cfg.grad_clip)
            return make_train_fns(m, bcx, mc, gsc, opt, dev, mesh=mesh)
        # ---- 12.3 DP eval in bf16 (the copies as they are) ----
        plain16, dp16 = fns(plain_m, bc), fns(dp_m, bc, mesh)
        with torch.no_grad():
            ev_p, e_p = counted(lambda: plain16.eval_step(batch1))
            ev_d, e_d = counted(lambda: dp16.eval_step(
                shard_batch(batch1, mesh)))
        ev_err = float((ev_d[0] - ev_p[0]).abs().max()
                       / (ev_p[0].abs().max() + 1e-12))
        log(f"DP eval (bf16, mesh 1): logits {tuple(ev_d[0].shape)}, "
            f"{ev_err:.3g} of scale from the plain eval (bit-identical "
            f"{torch.equal(ev_d[0], ev_p[0])}; tolerance {DP_EVAL_TOL}), "
            f"valid and labels equal {torch.equal(ev_d[1], ev_p[1])} "
            f"{torch.equal(ev_d[2], ev_p[2])}")
        if not (ev_err <= DP_EVAL_TOL and torch.equal(ev_d[1], ev_p[1])
                and torch.equal(ev_d[2], ev_p[2])):
            raise AssertionError("DP eval differs from the plain eval")
        same_launches("DP eval", e_p, e_d,
                      ("event_graph_search", "spline_fused_level0",
                       "spline_shift_pooled", "upsample_rows",
                       "bilinear_sample", "pool_graph"))
        # ---- 12.4 the DP head step in f32, and the plain step twice ----
        ctl_m = copy.deepcopy(plain_m)
        plain, dp = fns(plain_m, bc32), fns(dp_m, bc32, mesh)
        gens = [torch.Generator(device=dev).manual_seed(1) for _ in "abc"]
        # an op without a deterministic version warns on stderr
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            out_p, n_p = counted(lambda: plain.train_step(batch1, gens[0]))
            out_d, n_d = counted(lambda: dp.train_step(
                shard_batch(batch1, mesh), gens[1]))
            out_c = fns(ctl_m, bc32).train_step(batch1, gens[2])
        finally:
            torch.use_deterministic_algorithms(False)
        lp, ld, lc = (float(o["loss"]) for o in (out_p, out_d, out_c))

        def worst(m, ref, of):
            """The worst head leaf (``of(p)``: the parameter or its
            gradient) of ``m`` from ``ref``'s, of that leaf's scale."""
            return max(float((of(a) - of(b)).abs().max()
                             / (of(b).abs().max() + 1e-12))
                       for a, b in zip(m.head.parameters(),
                                       ref.head.parameters()))
        grad = lambda p: p.grad  # noqa: E731
        leaf = lambda p: p.detach()  # noqa: E731
        g_err, g_ctl = worst(dp_m, plain_m, grad), worst(ctl_m, plain_m,
                                                         grad)
        l_err, l_ctl = worst(dp_m, plain_m, leaf), worst(ctl_m, plain_m,
                                                         leaf)
        stats_equal = all(torch.equal(a, b) for a, b in zip(
            dp_m.buffers(), plain_m.buffers()))
        log(f"DP head step (f32, dropout on, mesh 1, deterministic "
            f"algorithms): loss {ld} vs {lp} without a group (the plain "
            f"step again: {lc}); head gradients (after the clip) worst "
            f"{g_err:.3g} of scale, leaves after the update worst "
            f"{l_err:.3g} (tolerance {DP_LEAF_TOL}; the plain step again "
            f"{g_ctl:.3g} / {l_ctl:.3g}); running statistics equal "
            f"{stats_equal}")
        if not (abs(ld - lp) <= DP_LOSS_TOL * abs(lp)
                and g_err <= DP_LEAF_TOL and l_err <= DP_LEAF_TOL
                and stats_equal and out_d["finite"] and out_p["finite"]):
            raise AssertionError("DP head step differs from the plain one")
        del ctl_m
        # (under deterministic algorithms the plain formulation pools)
        same_launches("DP head step", n_p, n_d,
                      ("event_graph_search", "gather_window_rows"))
        step_ms = {}
        for name, f, b in (("plain", plain, batch1),
                           ("mesh", dp, shard_batch(batch1, mesh))):
            ts = []
            for _ in range(DP_TIMED_STEPS):
                t0 = time.perf_counter()
                f.train_step(b, gens[0])
                torch.cuda.synchronize()
                ts.append((time.perf_counter() - t0) * 1e3)
            step_ms[name] = sorted(ts)[len(ts) // 2]
        del plain_m, dp_m, plain, dp, plain16, dp16

        # ---- 12.5 the detector's step on mesh 1x1 ----
        cfg32 = cfg.replace(compute_dtype="float32")
        det_p, bcd = tdet.init_detector(
            cfg32, torch.Generator().manual_seed(0), dev)
        det_d = copy.deepcopy(det_p)
        geom = anchor_geometry(bcd, dev)
        mesh11 = make_mesh("1x1")
        sharded = shard_params(det_d, mesh11)

        def det_step(det, params, sh):
            opt = make_detector_optimizer(
                params, cfg32.optimizer, lambda step: cfg32.lr,
                cfg32.weight_decay, cfg32.clip,
                grad_norm=None if sh is None else sh.grad_norm)
            return make_detector_train_step(det, cfg32, bcd, opt, geom, sh)
        step_p = det_step(det_p, list(det_p.parameters()), None)
        step_d = det_step(det_d, sharded.locals, sharded)
        ema_p = ema_init(det_p.parameters())
        ema_d = sharded_init(ema_init, sharded)
        (_, loss_p), d_p = counted(lambda: step_p(batch1, ema_p))
        (_, loss_d), d_d = counted(lambda: step_d(
            shard_batch(batch1, mesh11), ema_d))
        loss_d = {k: float(v) for k, v in loss_d.items()}
        worst = max(abs(loss_d[k] - float(v)) / max(abs(float(v)), 1e-12)
                    for k, v in loss_p.items())
        log(f"detector step (f32, mesh 1x1, {sharded.n_sharded} weights "
            f"sharded): losses {loss_d}, worst {worst:.3g} relative from "
            f"the replicated step's (tolerance {DP_DET_LOSS_TOL})")
        if not worst <= DP_DET_LOSS_TOL:
            raise AssertionError("the 1x1 detector step's losses differ")
        same_launches("detector step", d_p, d_d,
                      ("event_graph_search", "gather_window_rows",
                       "scatter_window_rows"))
        del det_p, det_d, sharded, step_p, step_d, ema_p, ema_d

        # ---- 12.6 seq_sharded_features at D = 1 against refresh ----
        n = cfg.event_buckets[0]
        cfg1 = cfg.replace(batch_size=1)
        g = torch.Generator().manual_seed(5)
        pos = torch.stack([
            torch.randint(0, cfg1.model_width, (n,), generator=g),
            torch.randint(0, cfg1.model_height, (n,), generator=g),
            1_000_000 + torch.sort(torch.randint(0, 200_000, (n,),
                                                 generator=g)).values],
            1).to(torch.int32).to(dev)
        pol = (torch.randint(0, 2, (n,), generator=g) * 2 - 1).float() \
            .to(dev)
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        image = torch.rand((cfg1.model_height, cfg1.model_width, 3),
                           generator=g).to(dev)
        seq_launches = {}
        for dt_name, bcx, tol in (
                ("float32", bc32._replace(batch_size=1), SEQ_SP_TOL),
                ("bfloat16", bc._replace(batch_size=1), SEQ_SP_BF16_TOL)):
            st = inc.update_image(model, inc.init_incremental_state(
                n, bcx, mc, cfg1.max_neighbors, dev), image)
            refresh, _ = inc.make_incremental_step(model, bcx, mc, gsc,
                                                   n_chunk=256, n_buf=n)
            ref_st = refresh(inc.insert_raw(st, pos, pol, n))
            with torch.no_grad():
                ref = inc.pooled_backbone_outs(
                    model, bcx, ref_st,
                    inc.norm_pos(ref_st.pos, ref_st.t_now, gsc), gsc)
            outs, seq_n = counted(lambda: seq_sharded_features(
                model, bcx, gsc, pos, pol, valid, st.image_feats,
                make_mesh("1")))
            errs = []
            for gr, gs in zip(ref, outs):
                if not torch.equal(gr.node_mask, gs.node_mask):
                    raise AssertionError("seq SP: active cells differ")
                m = gr.node_mask[:, None]
                xr = torch.where(m, gr.x.float(), 0.0)
                xs = torch.where(m, gs.x.float(), 0.0)
                errs.append(float((xr - xs).abs().max()
                                  / (xr.abs().max() + 1e-6)))
            log(f"seq_sharded_features ({dt_name}, D = 1, {n} events, "
                f"lookback {cfg1.graph_lookback}) vs refresh: out3/out4 "
                f"{errs} of scale (tolerance {tol}); launches {seq_n}")
            if not max(errs) <= tol:
                raise AssertionError(f"seq SP ({dt_name}) differs from "
                                     f"refresh: {errs}")
            need = {"event_graph_search", "gather_window_rows",
                    "pool_graph"}
            if dt_name == "bfloat16":
                need |= {"spline_shift_pooled", "bilinear_sample"}
            if not need <= set(seq_n):
                raise AssertionError(f"seq SP ({dt_name}) launched {seq_n}")
            seq_launches[dt_name] = seq_n
    finally:
        dist.destroy_process_group()
    times = dict(card=smi, head_step_ms=step_ms)
    log(f"parallel times on {smi}: f32 head step median of "
        f"{DP_TIMED_STEPS}: {step_ms['plain']:.2f} ms without a group, "
        f"{step_ms['mesh']:.2f} ms on the world-size-1 mesh")
    for r in records:
        r["dp_train_step_launches"] = n_d.get(r["name"], 0)
        r["dp_eval_launches"] = e_d.get(r["name"], 0)
        r["dp_detector_step_launches"] = d_d.get(r["name"], 0)
        r["seq_sp_launches"] = {k: v.get(r["name"], 0)
                                for k, v in seq_launches.items()}
    print(json.dumps({"parallel_times": times}), flush=True)
    return times


# phase 13: the bf16 scoring forward captured in a CUDA graph (the forward
# ``bench`` times on the card), and the device-true records of ``bench``
# and ``bench_streaming``, each module in a fresh process of its own (its
# profiler trace is then early in its process; late in this one a trace may
# lose device events)
GRAPH_EAGER_RUNS = 10     # eager forwards whose spread bounds two replays'
GRAPH_LAUNCHES = dict(event_graph_search=1, spline_fused_level0=2,
                      spline_shift_pooled=8, upsample_rows=1,
                      bilinear_sample=3, pool_graph=8)
# trace_device_ms may exceed the replay time by this: the profiler lengthens
# each of a forward's ~2 400 kernels; on one H100 the traced kernels of a
# capture summed to 6.19-6.25 ms while untraced replays of captures took
# 5.85-6.90 ms, 1.065 times at the most
TRACE_OVER_SCAN = 1.10
MODULE_TIMEOUT_S = 300


def module_records(module, *args):
    """The JSON records a ``python -m eventad_tpu_torch.<module>`` run prints,
    after echoing its standard output; raises if it fails."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", f"eventad_tpu_torch.{module}", *args],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=MODULE_TIMEOUT_S)
    for line in res.stdout.splitlines():
        log(f"{module}: {line}")
    if res.returncode != 0:
        raise AssertionError(f"{module} exited {res.returncode}:\n"
                             f"{res.stderr[-4000:]}")
    log(f"{module}: {time.perf_counter() - t0:.1f} s in a fresh process")
    return [json.loads(line) for line in res.stdout.splitlines()
            if line.startswith("{")]


def graph_phase(dev, smi, model, batch, cpu_ref, bc, mc, gsc, records,
                counters):
    """Phase 13 (see the module docstring).  ``batch``: batch 0 on the card;
    ``cpu_ref``: the port's CPU run of it (phase 4)."""
    from eventad_tpu_torch.bench_streaming import CARD_KEYS
    from eventad_tpu_torch.models.dagr import model_forward
    from eventad_tpu_torch.utils.devtime import capture

    seen = []

    def fwd():
        for c in counters.values():
            c.launches = 0
        with torch.no_grad():
            o = model_forward(model, batch, bc, mc, gsc)
        seen.append({n: c.launches for n, c in counters.items()
                     if c.launches})
        return o.logits, o.valid

    # ---- 13.1 the spread of eager forwards on the card ----
    eager = [fwd()[0].clone() for _ in range(GRAPH_EAGER_RUNS)]
    stack = torch.stack(eager)
    spread = float((stack.max(0).values - stack.min(0).values).max())
    # ---- 13.2 capture (after 3 warm-up forwards on a side stream) ----
    graph, (logits, valid) = capture(fwd)
    if seen[-1] != GRAPH_LAUNCHES:
        raise AssertionError(f"the captured forward launched {seen[-1]}, "
                             f"expected {GRAPH_LAUNCHES}")
    for r in records:
        r["graph_capture_launches"] = seen[-1].get(r["name"], 0)
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append(logits.clone())
    replay_diff = float((replays[0] - replays[1]).abs().max())
    v = cpu_ref.valid
    if not torch.equal(valid.cpu(), v) \
            or not bool(torch.isfinite(replays[0]).all()):
        raise AssertionError("graph replay: valid slots differ from the CPU "
                             "run, or logits not finite")
    d = (cpu_ref.logits[v] - replays[0].cpu()[v]).abs().max().item()
    log(f"graph-captured forward (bf16): launches during capture "
        f"{seen[-1]}; replay vs CPU logits max abs diff {d:.3g} over "
        f"{int(v.sum())} valid slots (tolerance {LOGIT_TOL}); two replays "
        f"{replay_diff:.3g} apart, {GRAPH_EAGER_RUNS} eager forwards "
        f"{spread:.3g} apart at most (the tolerance)")
    if not d < LOGIT_TOL:
        raise AssertionError(f"graph replay vs CPU logits differ by {d}")
    if not replay_diff <= spread:
        raise AssertionError(f"two replays differ by {replay_diff}, more "
                             f"than eager forwards ({spread})")
    del graph, logits, valid, replays, eager, stack

    # ---- 13.3 bench's records, in a fresh process ----
    recs = module_records("bench")
    if len(recs) != 4:
        raise AssertionError(f"bench printed {len(recs)} records, not 4")
    for a, b in zip(recs, recs[1:]):
        if {k: b.get(k) for k in a} != a:
            raise AssertionError("a bench record is no superset of the one "
                                 "before")
    last = recs[-1]
    scan, bound = last["scan_device_ms_per_batch"], last["roofline_bound_ms"]
    checks = {
        "0 < mfu < 1": 0 < last["mfu"] < 1,
        "no roofline_warning": "roofline_warning" not in last,
        "scan_device_ms_per_batch <= batch_ms": scan <= last["batch_ms"],
        f"trace_device_ms_per_batch <= {TRACE_OVER_SCAN} x scan":
            last["trace_device_ms_per_batch"] <= TRACE_OVER_SCAN * scan,
        "scan_device_ms_per_batch >= roofline_bound_ms": scan >= bound,
        "value, pipelined and train figures > 0": min(
            last["value"], last["pipelined_bboxes_per_sec"],
            last["train_items_per_sec"]) > 0}
    log(f"bench on {smi}: scan_device_ms_per_batch {scan:.4f}, batch_ms "
        f"{last['batch_ms']:.3f}, est_rtt_ms {last['est_rtt_ms']:.3f}, "
        f"trace_device_ms_per_batch {last['trace_device_ms_per_batch']:.4f}"
        f", mfu {last['mfu']:.5f} of {last['mfu_peak_tflops']} TFLOP/s, "
        f"hbm_gbps_min {last['hbm_gbps_min']:.1f}, bound {bound:.4f} ms; "
        f"checks {checks}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"bench records fail {failed}")

    # ---- 13.4 bench_streaming's device-time keys, in a fresh process ----
    (srec,) = module_records("bench_streaming")
    vals = {k: srec.get(k) for k in CARD_KEYS}
    log(f"bench_streaming on {smi}: {vals}")
    if not all(isinstance(x, float) and 0 < x < float("inf")
               for x in vals.values()) \
            or not vals["device_step_trace_ms"] <= vals["device_step_ms"]:
        raise AssertionError(f"bench_streaming's device keys {vals}")
    times = dict(card=smi, eager_spread=spread, replay_diff=replay_diff,
                 replay_vs_cpu=d, bench=recs, bench_streaming=srec)
    print(json.dumps({"graph_times": times}), flush=True)
    return times


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
    from eventad_tpu_torch.models.graph import upsample_lookup
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
        alone_ms = 0.0
        for a, kw in op_calls[name]:
            got = cuda_fn(*a, **kw)
            err = max(err, compare(name, got, plain_fn(*a, **kw), kw))
            ms += median_ms(lambda: cuda_fn(*a, **kw))
            alone_ms += launch_ms(mods[mod], lambda: cuda_fn(*a, **kw))
            plain_ms += median_ms(lambda: plain_fn(*a, **kw))
            nbytes += BYTES.get(name, all_bytes)(a, kw, got)
            n_ops, peak = OPS[name](a, kw, got)
            ops += n_ops
        bound_ms, bound_by = bound(nbytes, ops, peak)
        dense_err, dense_alone_ms = 0.0, 0.0
        for a, kw in dense_calls[name]:
            dense_err = max(dense_err, compare(name, cuda_fn(*a, **kw),
                                               plain_fn(*a, **kw), kw))
            dense_alone_ms += launch_ms(mods[mod],
                                        lambda: cuda_fn(*a, **kw))
        shapes = [tuple(t.shape) for t in op_calls[name][0][0]
                  if isinstance(t, torch.Tensor)]
        record = dict(name=name, route="cuda", source=src, replaces=replaces,
                      max_abs_err=max(err, dense_err), ms=ms,
                      launch_ms=alone_ms, dense_launch_ms=dense_alone_ms,
                      plain_ms=plain_ms, bound_ms=bound_ms,
                      bound_by=bound_by, library_ms=None)
        library = "no single PyTorch call computes it"
        if name == "upsample_rows":
            # against the plain version before the tap tables as well
            # (two interpolation products in the maps' type, W then H)
            lookup = 0.0
            for a, kw in op_calls[name] + dense_calls[name]:
                feats, pos, batch, width, height = a
                want = upsample_lookup(feats, pos, batch, None, width,
                                       height, mask_rows=False)
                d = (cuda_fn(*a, **kw).float() - want.float()).abs().max()
                scale = want.float().abs().max().item() + 1e-6
                if not d.item() <= KERNEL_TOL * scale:
                    raise AssertionError(f"upsample_rows vs upsample_lookup"
                                         f": max abs err {d.item()} > "
                                         f"{KERNEL_TOL} x {scale}")
                lookup = max(lookup, d.item())
            record.update(lookup_max_abs_err=lookup)
            lib = [upsample_library(a, plain_fn(*a, **kw))
                   for a, kw in op_calls[name]]
            record.update(library_ms=sum(x[1] for x in lib),
                          library_launch_ms=sum(x[2] for x in lib),
                          library_max_abs_diff=max(x[0] for x in lib))
            library = (f"max abs err vs upsample_lookup {lookup:.3g}; "
                       f"F.grid_sample (align_corners) of each map "
                       f"{record['library_ms']:.4f} ms with its layout "
                       f"copies, alone {record['library_launch_ms']:.4f} ms"
                       f", max abs diff from the plain version "
                       f"{record['library_max_abs_diff']:.3g}")
        log(f"{name}: {len(op_calls[name])} call(s) per forward, first input"
            f" shapes {shapes}; max abs err {err:.3g} (dense / under-filled"
            f" batch {dense_err:.3g}); kernel {ms:.4f} ms (launches alone "
            f"{alone_ms:.4f} ms; dense batch {dense_alone_ms:.4f}), plain "
            f"{plain_ms:.4f} ms per forward; bound {bound_ms:.5f} ms by "
            f"{bound_by} ({nbytes} bytes, {ops} operations); {library}")
        records.append(record)

    def edges_per_event(calls):
        nbr = calls["spline_fused_level0"][0][0][1].nbr
        return float((nbr >= 0).sum()) / nbr.shape[0]
    log(f"level-0 edges per event (self edge excluded): operating point "
        f"{edges_per_event(op_calls):.3f}, dense batch "
        f"{edges_per_event(dense_calls):.3f}")

    # K1, K2, K3 and K7 on shapes the path does not reach
    ssm, bb = mods["spline_shift"], importlib.import_module(
        "eventad_tpu_torch.models.backbone")
    s_cases = check_search_general(dev)
    log(f"event_graph_search, general geometries: {s_cases} cases (k_other "
        f"1, 8, 15; 64-bit keys at radius 100; lookback 2048 at "
        f"configs/dota.yaml's 320x180; an unsorted item; invalid events "
        f"between valid ones whose times fall; a t = 0 tail; N 5000, 4097): "
        f"equal to the plain version exactly")
    l_err, l_cases = check_level0_general(dev)
    log(f"spline_fused_level0, general shapes: {l_cases} cases (C 1, 7, 19, "
        f"33, 40, 64, 67, 256; O 4, 8, 12, 13, 16, 32, 40, 64, 136, 256; "
        f"block 1 without, block 2 with the skip; every activation; full "
        f"and sub-rectangle taps; weights in shared and in device memory; "
        f"tiles without an edge, 997 rows): max abs err {l_err:.3g} of "
        f"scale (tolerance {KERNEL_TOL}), h and output")
    g_err, g_err_rounded, g_runs, g_plans = check_shift_general(dev)
    log(f"spline_shift_pooled, general shapes: {g_runs} runs ("
        f"cases of (C, O, Cs, act, N); O 5-256, odd C and O, C 256 with "
        f"two column groups, O 136 with a ragged last group, groups of 64 "
        f"where 128 do not fit; (C, O, Cs, N, row tile, column group) "
        f"{g_plans}; every activation, "
        f"row tiles of 16, 32 and 128 by N, tiles with no edge, every slot "
        f"an edge): max abs err {g_err:.3g} of scale against the "
        f"plain version (tolerance {KERNEL_TOL}), {g_err_rounded:.3g} "
        f"against the plain version with z rounded to bf16")
    b_err, b_cases = check_bilinear_general(dev)
    log(f"sample_bilinear, general shapes: {b_cases} cases (C 1, 3, 20, 64; "
        f"997 rows; f32 and bf16; dense and out= column ranges at offsets "
        f"8 and 3): worst error {b_err:.3g} of its tolerance; nothing "
        f"written outside a column range")
    w_rows, w_total = check_gather_wide(dev)
    log(f"gather_window_rows, 64-bit instantiation: bf16, C 19, K 15, "
        f"{w_total} output elements (2^31 = {2 ** 31}); {w_rows} sampled "
        f"rows (random, around flat index 2^31, the last) equal to the "
        f"plain version exactly")
    # K8 on the forward's four poolings at the 16 384 bucket and at the
    # 32 768 one, each call in four variants
    big = make_synthetic_batch(cfg, seed=RUNS, events_per_item=32768,
                               boxes_per_item=BOXES_PER_ITEM).to(dev)
    pool_calls = op_calls["pool_graph"] + recorded_forward(big)["pool_graph"]
    POOL_STATS.update(calls=0, cells=0, step_cells=0, step_pos_nbr=0)
    p_cases, p_err = check_pool_cases(pool_calls)
    log(f"pool_graph, the forward's {len(pool_calls)} poolings (rows in "
        f"{[a[0].shape[0] for a, _ in pool_calls]}): {p_cases} cases (as "
        f"recorded: bf16, pos_src, max / mean at "
        f"level 4; through nbr with the temporal ordering; f32 with the "
        f"other aggregation and pos_nbr; f32 through nbr, temporal, "
        f"pos_nbr): features of a max, masks, indices, active and batch "
        f"equal to the plain formulation exactly; mean features and t "
        f"within {p_err:.3g} of scale; {POOL_STATS['step_cells']} of "
        f"{POOL_STATS['cells']} cells and {POOL_STATS['step_pos_nbr']} "
        f"pos_nbr entries one pixel step apart (an f32 mean on a pixel "
        f"boundary)")

    k3_calls = op_calls["spline_shift_pooled"]
    per_row = [round(float(a[1].mq.sum()) / a[1].mq.shape[0], 3)
               for a, _ in k3_calls[::2]]
    per_call = [launch_ms(ssm, lambda: ssm.shift_spline_conv_cuda(*a, **kw))
                for a, kw in k3_calls]
    log(f"pooled-level edges per row (of 25 slots), levels 1-4: {per_row}; "
        f"launches alone per call {[round(t, 4) for t in per_call]} ms")

    # after the first forward the K3 path copies nothing to the card and
    # prepares nothing per call: the static tables and the packs are the
    # same objects, and a trace of prepare_shift + the two blocks of every
    # pooled level shows the eight launches and no other device operation
    preps = []
    orig_prepare = bb.prepare_shift

    def rec_prepare(*a, **kw):
        preps.append((a, kw))
        return orig_prepare(*a, **kw)
    bb.prepare_shift = rec_prepare
    try:
        again = recorded_forward(batches[0])
    finally:
        bb.prepare_shift = orig_prepare
    again_calls = again["spline_shift_pooled"]
    k2_call, k2_again = (c["spline_fused_level0"][0]
                         for c in (op_calls, again))
    if k2_call[0][2] is not k2_again[0][2] \
            or k2_call[0][3] is not k2_again[0][3]:
        raise AssertionError("K2: operands were packed anew")
    if len(preps) != 4 or len(again_calls) != 8:
        raise AssertionError(f"{len(preps)} prepare_shift and "
                             f"{len(again_calls)} shift_spline_conv calls")
    static = ("d_offs", "tap_mxy", "tap_ptr", "tap_slots", "tap_idx",
              "win_mask")
    for (a, kw), (a2, kw2) in zip(k3_calls, again_calls):
        if any(getattr(a[1], f) is not getattr(a2[1], f) for f in static):
            raise AssertionError("K3: a static table was made anew")
        if any(x is not y for x, y in zip(a[2:], a2[2:])) \
                or kw["pack"] is None or kw["pack"] is not kw2["pack"]:
            raise AssertionError("K3: operands were packed anew")

    # (the only trace of this run, and early in it: later in a process
    # the tracing layer was seen to lose device events)
    from torch.profiler import ProfilerActivity, profile
    k1_a, k1_kw = again["event_graph_search"][0]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i, (pa, pkw) in enumerate(preps):
            prep = bb.prepare_shift(*pa, **pkw)
            for a, kw in again_calls[2 * i:2 * i + 2]:
                ssm.shift_spline_conv_cuda(a[0], prep, *a[2:], **kw)
        mods["event_graph"].build_graph_cuda(*k1_a, **k1_kw)
        mods["spline_fused"].fused_two_block_cuda(*k2_again[0],
                                                  **k2_again[1])
        torch.cuda.synchronize()
    dev_ops = {e.key: e.count for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")
               and not getattr(e, "is_user_annotation", False)}
    traced = {"shift_block_kernel": 8, "search_kernel": 1,
              "level0_block_kernel": 2}
    seen = {name: sum(v for k, v in dev_ops.items() if name in k)
            for name in traced}
    others = {k: v for k, v in dev_ops.items()
              if not any(name in k for name in traced)}
    if others or seen != traced:
        raise AssertionError(f"traced K1, K2 and K3 calls of one forward: "
                             f"launches {seen}, other device operations "
                             f"{others}")
    log(f"spline_shift_pooled / spline_fused_level0: a second forward "
        f"reuses the static tables and the packs (same objects); traced "
        f"prepare_shift + 2 blocks x 4 levels, one K1 call and one level-0 "
        f"layer: kernel launches {seen}, no copy to the card and no other "
        f"device operation")

    # a weight changed in place reaches the kernel: the pack is not stale
    conv1 = model.dagr.backbone.layers[1].block1.conv
    a, kw = k3_calls[0]
    with torch.no_grad():
        conv1.weight.mul_(2)
    try:
        a2, kw2 = recorded_forward(batches[0])["spline_shift_pooled"][0]
        if a2[2] is a[2] or not torch.equal(a2[2], a[2] * 2) \
                or kw2["pack"] is kw["pack"]:
            raise AssertionError("K3: the in-place weight change did not "
                                 "reach the layer's operands and pack")
        got2 = ssm.shift_spline_conv_cuda(*a2, **kw2)
        stale_err = compare("spline_shift_pooled", got2,
                            ssm.shift_spline_conv_plain(*a2, **kw2))
        moved = (got2.float() - ssm.shift_spline_conv_cuda(*a, **kw).float()
                 ).abs().max().item()
    finally:
        with torch.no_grad():
            conv1.weight.div_(2)
    a3, _ = recorded_forward(batches[0])["spline_shift_pooled"][0]
    if not torch.equal(a3[2], a[2]) or not moved > 0:
        raise AssertionError("K3: the weight change is not undone, or "
                             "changed nothing")
    log(f"spline_shift_pooled: weight.mul_(2) in place -> packed anew, max "
        f"abs err {stale_err:.3g} against the plain version on the doubled "
        f"weight, output moved by {moved:.3g}; undone by div_(2)")

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
    if launches["pool_graph"] != 8 * RUNS:
        raise AssertionError(f"pool_graph: {launches['pool_graph']} "
                             f"launches over {RUNS} forwards, expected "
                             f"{8 * RUNS} (two a pooling)")
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
    cpu_refs_bf16 = []
    for i in (0, 1):
        t0 = time.perf_counter()
        ref = model_forward(cpu_model, cpu_batches[i], bc, mc, gsc)
        cpu_refs_bf16.append(ref)
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
        of the level-0 apply_layer (its route among them) recorded at their
        call sites."""
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
        also twice the same bits, and a bf16 cotangent (twice the same
        bits too)."""
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
        if not torch.equal(got16, gw.scatter_window_rows_cuda(
                g16, nbr, mask, n_src, **kw)):
            raise AssertionError("scatter_window_rows (bf16): two runs "
                                 "differ")
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
    g_alone = s_alone = g_lib_alone = s_lib_alone = g_dense_alone = 0.0
    s_dense_alone = 0.0
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
        g_alone += launch_ms(gw, lambda: gw.gather_window_rows_cuda(*a, **kw))
        s_alone += launch_ms(gw, lambda: gw.scatter_window_rows_cuda(
            g, nbr, mask, n_src, **kw))
        g_plain += median_ms(lambda: gw.gather_window_rows_plain(*a))
        g_lib += median_ms(lambda: src[idx])
        g_lib_alone += graph_ms(lambda: src[idx])
        s_ms += median_ms(lambda: gw.scatter_window_rows_cuda(
            g, nbr, mask, n_src, **kw))
        s_plain += median_ms(lambda: gw.scatter_window_rows_plain(
            g, nbr, mask, n_src))
        flat_idx = idx.reshape(-1)
        gm = torch.where(mask[..., None], g, 0.0).reshape(-1, c)
        def index_add():
            return torch.zeros((n_src, c), device=dev).index_add_(
                0, flat_idx, gm)
        s_lib += median_ms(index_add)
        s_lib_alone += graph_ms(index_add)
        edges = int(mask.sum())
        out_bytes = mask.numel() * c * src.element_size()
        # the gather needs the mask whole, nbr only at its edges and each
        # source row an edge points to once, and writes the output
        rows_read = int(torch.unique(nbr[mask]).numel())
        g_bytes += (tensor_bytes(mask) + edges * nbr.element_size()
                    + rows_read * c * src.element_size() + out_bytes)
        # the scatter needs the mask whole, and nbr and the cotangent's rows
        # only at its edges, and writes the output
        s_bytes += (tensor_bytes(mask) + edges * nbr.element_size()
                    + edges * c * g.element_size()
                    + n_src * c * src.element_size())
        s_ops += edges * c
        del g, gm
    for a, kw in dense_g:
        check_gather(a, kw)
        err, seq, g = check_scatter(a, kw)
        s_err, s_seq = max(s_err, err), s_seq and seq
        g_dense_alone += launch_ms(gw, lambda: gw.gather_window_rows_cuda(
            *a, **kw))
        s_dense_alone += launch_ms(gw, lambda: gw.scatter_window_rows_cuda(
            g, a[1], a[2], a[0].shape[0], **kw))
        del g
    g_bound, g_by = bound(g_bytes, 0, PEAK_F32)
    s_bound, s_by = bound(s_bytes, s_ops, PEAK_F32)
    shapes = [tuple(t.shape) for t in op_g[0][0]]
    log(f"gather_window_rows: 2 calls per f32 forward, first input shapes "
        f"{shapes}; equal to the plain version exactly (f32 and bf16, both "
        f"batches); kernel {g_ms:.4f} ms (launches alone {g_alone:.4f} ms; "
        f"dense batch {g_dense_alone:.4f}), plain {g_plain:.4f} ms, indexed "
        f"gather src[idx] {g_lib:.4f} ms (alone {g_lib_alone:.4f}) per "
        f"forward; bound {g_bound:.5f} ms by {g_by} ({g_bytes} bytes)")
    log(f"scatter_window_rows: cotangents of the same shapes, both "
        f"batches; max abs err vs index_add_ {s_err:.3g} (tolerance "
        f"{SCATTER_TOL} of scale; bf16 {SCATTER_BF16_TOL}); two runs "
        f"bit-identical (f32 and bf16); equal to the CPU's sequential "
        f"index_add_ exactly: {s_seq}; two launches a call; kernel "
        f"{s_ms:.4f} ms (launches alone {s_alone:.4f} ms; dense batch "
        f"{s_dense_alone:.4f}), plain "
        f"{s_plain:.4f} ms, "
        f"index_add_ {s_lib:.4f} ms (alone {s_lib_alone:.4f}) for both; "
        f"bound {s_bound:.5f} ms by "
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
    # two gathers forward, two scatters of two launches each backward
    if grad_launches != (2, 4):
        raise AssertionError(f"level-0 gradient: (gather, scatter) launches "
                             f"{grad_launches}, expected (2, 4)")
    kernel_route = bb.gather_rows_auto
    bb.gather_rows_auto = lambda s, n, m, lookback: \
        gw.gather_window_rows_plain(s, n, m)
    try:
        grad_plain = layer_input_grad()
    finally:
        bb.gather_rows_auto = kernel_route
    if gw.scatter_window_rows_cuda.launches != 4:
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
    counters["pool_graph"].launches = 0
    ts32, outs32 = [], []
    for i in range(RUNS):
        t0 = time.perf_counter()
        o = model_forward(model, batches[i], bc32, mc, gsc)
        torch.cuda.synchronize()
        ts32.append(time.perf_counter() - t0)
        outs32.append(o)
    f32_launches = dict(event_graph_search=build_graph_cuda.launches,
                        gather_window_rows=gw.gather_window_rows_cuda
                        .launches,
                        pool_graph=counters["pool_graph"].launches)
    log(f"launches over {RUNS} f32 forwards: {f32_launches}")
    if f32_launches != dict(event_graph_search=RUNS,
                            gather_window_rows=2 * RUNS,
                            pool_graph=8 * RUNS):
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
        ms=g_ms, launch_ms=g_alone, dense_launch_ms=g_dense_alone,
        plain_ms=g_plain, bound_ms=g_bound, bound_by=g_by, library_ms=g_lib,
        library_launch_ms=g_lib_alone))
    records.append(dict(
        name="scatter_window_rows", route="cuda", source=gather_src,
        replaces="eventad_tpu/ops/gather_window.py:169",
        launches=grad_launches[1], max_abs_err=s_err, ms=s_ms,
        launch_ms=s_alone, dense_launch_ms=s_dense_alone,
        plain_ms=s_plain, bound_ms=s_bound, bound_by=s_by,
        library_ms=s_lib, library_launch_ms=s_lib_alone))

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
                             gather_window_rows=2 * TRAIN_STEPS,
                             pool_graph=8 * TRAIN_STEPS)),
            ("bfloat16", dict(event_graph_search=TRAIN_STEPS,
                              spline_fused_level0=2 * TRAIN_STEPS,
                              spline_shift_pooled=8 * TRAIN_STEPS,
                              upsample_rows=TRAIN_STEPS,
                              pool_graph=8 * TRAIN_STEPS))):
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


    # ---- 7. the other kernel flavours: K5 (base), K7 (bilinear) ----
    import torch.nn.functional as F

    from eventad_tpu_torch.ops import bilinear_sample as bsm
    from eventad_tpu_torch.ops import nms
    from eventad_tpu_torch.ops import spline_fused as sfm

    bc_base, bc_bil = bc._replace(**BASE), bc._replace(**BILINEAR)
    all_counters = dict(all_counters,
                        fused_spline_conv=sfm.fused_spline_conv_cuda,
                        bilinear_sample=bsm.sample_bilinear_cuda,
                        postprocess=nms.postprocess_cuda)

    def recorded_calls(batch, bcx, mod, attr, expect):
        """The scoring forward in flavour ``bcx`` with the arguments of
        ``mod.<attr>``, as the backbone calls it, recorded."""
        found, orig = [], getattr(mod, attr)

        def rec(*a, **kw):
            found.append((a, kw))
            return orig(*a, **kw)
        setattr(mod, attr, rec)
        try:
            model_forward(model, batch, bcx, mc, gsc)
            torch.cuda.synchronize()
        finally:
            setattr(mod, attr, orig)
        if len(found) != expect:
            raise AssertionError(f"{attr}: {len(found)} calls in one "
                                 f"forward, expected {expect}")
        return found

    def conv_err(a, kw):
        got = sfm.fused_spline_conv_cuda(*a, **kw)
        want = sfm.fused_spline_conv_plain(*a, **kw)
        if got.shape != want.shape or got.dtype != torch.float32:
            raise AssertionError(f"fused_spline_conv: {got.shape} "
                                 f"{got.dtype} vs {want.shape}")
        no_edge = ~(a[1].nbr >= 0).any(1)
        if not bool((got[no_edge] == 0).all()):
            raise AssertionError("fused_spline_conv: a row without an edge "
                                 "is not zero")
        err = (got - want).abs().max().item()
        scale = want.abs().max().item() + 1e-6
        if not err <= FUSED_CONV_TOL * scale:
            raise AssertionError(f"fused_spline_conv: max abs err {err} > "
                                 f"{FUSED_CONV_TOL} x {scale}")
        return err, got

    k5_op = recorded_calls(batches[0], bc_base, sfm, "fused_spline_conv", 10)
    k5_dense = recorded_calls(dense, bc_base, sfm, "fused_spline_conv", 10)
    # the packs are made once per layer: the second forward passes the
    # same objects
    if any(kw["pack"] is None or kw["pack"] is not kw2["pack"]
           for (_, kw), (_, kw2) in zip(k5_op, k5_dense)):
        raise AssertionError("K5: the weights were packed anew")
    k5_err = k5_plain = 0.0
    level_ms, k5_alone, k5_dense_alone, k5_bounds, k5_plans = \
        [], [], [], [], []
    k5_bytes = k5_tap_ops = k5_z_ops = 0
    for a, kw in k5_op:
        src, prep, weight = a
        err, got = conv_err(a, kw)
        k5_err = max(k5_err, err)
        level_ms.append(median_ms(lambda: sfm.fused_spline_conv_cuda(
            *a, **kw)))
        k5_alone.append(launch_ms(sfm, lambda: sfm.fused_spline_conv_cuda(
            *a, **kw)))
        k5_plain += median_ms(lambda: sfm.fused_spline_conv_plain(*a, **kw),
                              reps=5)
        # what this data needs: per edge its (at most four) taps' share of
        # z, per (row, tap) that an edge touches one C x O product; of the
        # weights only the taps some edge touches
        coeff = sfm._tap_coeff(prep, kw["kernel_size"], kw["ranges"])
        c, o = src.shape[1], weight.shape[-1]
        used = coeff != 0
        z_ops = 2 * int(used.sum()) * c
        tap_ops = 2 * int(used.any(1).sum()) * c * o
        taps_used = int(used.flatten(0, 1).any(0).sum())
        # the index table in full; coordinates only of the slots that hold
        # an edge (an empty slot's are never read); of src only the rows
        # that an edge points to (the root product is the caller's)
        edge_nbr = prep.nbr[prep.nbr >= 0]
        nbytes = (tensor_bytes((prep.nbr, got))
                  + edge_nbr.numel() * 2 * prep.u.element_size()
                  + int(torch.unique(edge_nbr).numel()) * c
                  * src.element_size()
                  + taps_used * c * o * 2)
        k5_bounds.append(max(nbytes / HBM_BYTES_PER_S, tap_ops / PEAK_BF16
                             + z_ops / PEAK_F32) * 1e3)
        k5_plans.append(sfm.fused_tiles(src.shape[0], c, prep.nbr.shape[1],
                                        o, coeff.shape[-1]))
        k5_z_ops, k5_tap_ops, k5_bytes = (k5_z_ops + z_ops,
                                          k5_tap_ops + tap_ops,
                                          k5_bytes + nbytes)
        del coeff
    k5_ms = sum(level_ms)
    k5_dense_err = 0.0
    for a, kw in k5_dense:
        k5_dense_err = max(k5_dense_err, conv_err(a, kw)[0])
        k5_dense_alone.append(launch_ms(
            sfm, lambda: sfm.fused_spline_conv_cuda(*a, **kw)))
    k5_by_bytes = k5_bytes / HBM_BYTES_PER_S
    k5_by_ops = k5_tap_ops / PEAK_BF16 + k5_z_ops / PEAK_F32
    k5_bound = max(k5_by_bytes, k5_by_ops) * 1e3
    k5_by = "bytes" if k5_by_bytes >= k5_by_ops else "operations"
    shapes = [(tuple(a[0].shape), tuple(a[1].nbr.shape), a[2].shape[-1])
              for a, _ in k5_op]

    def rounded(ts):
        return [round(t, 4) for t in ts]
    log(f"fused_spline_conv: 10 calls per base forward, (src, nbr, O) "
        f"{shapes}; (row tile, column group, staged rows, slab kernel, "
        f"blocks a tile) "
        f"{k5_plans}; "
        f"packs made once per layer; max abs err {k5_err:.3g} (dense / "
        f"under-filled batch {k5_dense_err:.3g}; tolerance "
        f"{FUSED_CONV_TOL} of scale); kernel ms per call "
        f"{rounded(level_ms)}, {k5_ms:.4f} ms per forward (launches alone "
        f"{rounded(k5_alone)}, {sum(k5_alone):.4f} ms; the two level-1 "
        f"calls {sum(k5_alone[2:4]):.4f} ms; dense batch "
        f"{rounded(k5_dense_alone)}, {sum(k5_dense_alone):.4f} ms), plain "
        f"{k5_plain:.4f} ms; bound per call "
        f"{[round(t, 5) for t in k5_bounds]}, {k5_bound:.5f} ms by "
        f"{k5_by} ({k5_bytes} bytes, {k5_tap_ops} tap-product and "
        f"{k5_z_ops} z operations); no single PyTorch call computes it")
    f_err, f_cases, f_plans = check_fused_general(dev)
    log(f"fused_spline_conv, general shapes: {f_cases} cases (C 1, 19, 67, "
        f"82, 130, 256, 512; O 4, 13, 40, 64, 136, 256, 512; level 0 and "
        f"pooled geometries, both kernels, tiles shared by clusters, every "
        f"slot an edge, unaligned sources; (C, O, N, row tile, column group, "
        f"staged rows, slab kernel, blocks a tile, most edges of a tile) "
        f"{f_plans}): max abs err {f_err:.3g} of scale (tolerance "
        f"{FUSED_CONV_TOL}); rows without an edge exactly zero")

    def bilinear_err(feat, pos, mask, kw):
        """One call as the path makes it: ``out=`` the recorded view's
        column range of a fresh table of the path's width, filled with a
        sentinel, whose other columns must stay untouched."""
        view = kw["out"]
        n_rows, c = view.shape
        width = view.stride(0)
        off = view.storage_offset() % width
        table = torch.full((n_rows, width), 7.0, dtype=feat.dtype,
                           device=dev)
        plain_kw = {k: v for k, v in kw.items() if k != "out"}
        got = bsm.sample_bilinear_cuda(feat, pos, mask,
                                       out=table[:, off:off + c], **plain_kw)
        want = bsm.sample_bilinear_plain(feat, pos, mask, **plain_kw)
        if got.shape != want.shape or got.dtype != feat.dtype \
                or got.data_ptr() != table[:, off:].data_ptr():
            raise AssertionError(f"sample_bilinear: {got.shape} {got.dtype}, "
                                 f"or not the view it was given")
        if not (bool((table[:, :off] == 7).all())
                and bool((table[:, off + c:] == 7).all())):
            raise AssertionError("sample_bilinear: wrote outside its column "
                                 "range of the path's table")
        if not bool((got[~mask] == 0).all()):
            raise AssertionError("sample_bilinear: a masked row is not zero")
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item() + 1e-6
        if not err <= BILINEAR_TOL[feat.dtype] * scale:
            raise AssertionError(
                f"sample_bilinear ({feat.dtype}): max abs err {err} > "
                f"{BILINEAR_TOL[feat.dtype]} x {scale}")
        return err, err / scale, got

    def one_table(calls):
        """The sampler's recorded calls, whose ``out=`` views must be the
        two column ranges of one table."""
        views = [kw["out"] for _, kw in calls]
        if len({v.untyped_storage().data_ptr() for v in views}) != 1 \
                or views[1].data_ptr() - views[0].data_ptr() \
                != views[0].shape[1] * views[0].element_size() \
                or views[0].stride(0) != sum(v.shape[1] for v in views):
            raise AssertionError("sample_bilinear: the two calls do not "
                                 "write one table's column ranges")
        return calls

    # the bilinear flavour's level-0/1 rows (its first two calls), and the
    # pooled levels 2-4, one call a level in every bf16 forward on the card
    k7_op = one_table(recorded_calls(batches[0], bc_bil, bb,
                                     "sample_bilinear", 5)[:2])
    k7_dense = one_table(recorded_calls(dense, bc_bil, bb,
                                        "sample_bilinear", 5)[:2])
    k7_pooled = recorded_calls(batches[0], bc, bb, "sample_bilinear", 3)
    k7_pooled_dense = recorded_calls(dense, bc, bb, "sample_bilinear", 3)
    k7_rel = {torch.float32: 0.0, torch.bfloat16: 0.0}
    k7_abs = 0.0
    k7_ms = k7_plain = k7_lib = k7_alone = k7_lib_alone = 0.0
    k7_bytes = k7_ops = 0
    for calls in (k7_op, k7_dense, k7_pooled, k7_pooled_dense):
        for a, kw in calls:
            feat, pos, mask = a
            # a copy whose positions also leave the map, on every side, and
            # whose mask drops rows
            far = pos.clone()
            far[:, :2] = far[:, :2] * 1.2 - 0.1
            far[:4, 0] = torch.tensor([1e9, -1e9, 0.0, 1.0], device=dev)
            fewer = mask & (torch.rand(mask.shape, generator=cot_gen,
                                       device=dev) > 0.15)
            for f in (feat, feat.float()):
                for p, m in ((pos, mask), (far, fewer)):
                    err, rel, _ = bilinear_err(f, p, m, kw)
                    k7_rel[f.dtype] = max(k7_rel[f.dtype], rel)
                    k7_abs = max(k7_abs, err)
    # timed as recorded: each call writes its column range of the path's
    # own table
    for a, kw in k7_op:
        feat, pos, mask = a
        plain_kw = {k: v for k, v in kw.items() if k != "out"}
        k7_ms += median_ms(lambda: bsm.sample_bilinear_cuda(*a, **kw))
        k7_alone += launch_ms(bsm, lambda: bsm.sample_bilinear_cuda(*a, **kw))
        k7_plain += median_ms(lambda: bsm.sample_bilinear_plain(*a, **kw),
                              reps=5)
        # the library's call: grid_sample on the NCHW map and a prepared
        # grid (neither conversion is timed).  It wants the grid in the
        # map's type, and a bf16 grid cannot hold a position, so it is held
        # against the kernel in f32 and timed in the map's type
        b, hp, wp, c = feat.shape
        nchw = feat.permute(0, 3, 1, 2).contiguous()
        gx = pos[:, 0] * bc.width / max(bc.width - 1, 1) * 2 - 1
        gy = pos[:, 1] * bc.height / max(bc.height - 1, 1) * 2 - 1
        grid = torch.stack([gx, gy], -1).reshape(b, 1, -1, 2)
        lib = F.grid_sample(nchw.float(), grid, mode="bilinear",
                            padding_mode="zeros", align_corners=True)
        lib = lib[:, :, 0].permute(0, 2, 1).reshape(kw["out"].shape) \
            * mask[:, None]
        got32 = bsm.sample_bilinear_cuda(feat.float(), pos, mask, **plain_kw)
        lib_err = (lib - got32).abs().max().item()
        if not lib_err <= 1e-3 * (got32.abs().max().item() + 1e-6):
            raise AssertionError(f"sample_bilinear vs grid_sample: {lib_err}")
        del lib, got32
        grid = grid.to(feat.dtype)
        def lib_call():
            return F.grid_sample(nchw, grid, mode="bilinear",
                                 padding_mode="zeros", align_corners=True)
        k7_lib += median_ms(lib_call)
        k7_lib_alone += graph_ms(lib_call)
        k7_bytes += tensor_bytes(a) + tensor_bytes(kw)     # out= among kw
        k7_ops += 9 * kw["out"].numel()
    k7_bound, k7_by = bound(k7_bytes, k7_ops, PEAK_F32)
    # levels 2-4 against the lookup K7 replaced there: within one bf16 step
    # of scale of its f32 evaluation on the same map, and no farther from
    # that than its bf16 evaluation, which rounds each product
    from eventad_tpu_torch.models.graph import sample_image_features
    k7p_err = k7p_err16 = 0.0
    k7p_ms = k7p_alone = k7p_plain = 0.0
    for a, kw in k7_pooled + k7_pooled_dense:
        feat, pos, mask = a
        plain_kw = {k: v for k, v in kw.items() if k != "out"}
        got = bsm.sample_bilinear_cuda(feat, pos, mask, **plain_kw).float()
        want32, want16 = (sample_image_features(
            f, pos, kw["batch"], mask, bc.width, bc.height).float()
            for f in (feat.float(), feat))
        scale = want32.abs().max().item() + 1e-6
        err = (got - want32).abs().max().item()
        err16 = (want16 - want32).abs().max().item()
        if not (err <= torch.finfo(torch.bfloat16).eps * scale
                and err <= err16):
            raise AssertionError(
                f"sample_bilinear at {tuple(feat.shape)}, {pos.shape[0]} "
                f"rows: {err} from the f32 lookup (scale {scale}; its bf16 "
                f"evaluation {err16})")
        k7p_err, k7p_err16 = max(k7p_err, err / scale), max(k7p_err16,
                                                            err16 / scale)
    for a, kw in k7_pooled:
        feat, pos, mask = a
        k7p_ms += median_ms(lambda: bsm.sample_bilinear_cuda(*a, **kw))
        k7p_alone += launch_ms(bsm, lambda: bsm.sample_bilinear_cuda(*a,
                                                                     **kw))
        k7p_plain += median_ms(lambda: sample_image_features(
            feat, pos, kw["batch"], mask, bc.width, bc.height), reps=5)
    log(f"sample_bilinear at the pooled levels 2-4: 3 calls per bf16 "
        f"forward, maps {[tuple(a[0].shape) for a, _ in k7_pooled]} at "
        f"{[a[1].shape[0] for a, _ in k7_pooled]} positions (and the dense "
        f"batch's), each into the image columns of its level's input table; "
        f"vs the f32 sample_image_features max {k7p_err:.3g} of scale "
        f"(tolerance {torch.finfo(torch.bfloat16).eps}; its bf16 evaluation "
        f"{k7p_err16:.3g}); kernel {k7p_ms:.4f} ms (launches alone "
        f"{k7p_alone:.4f} ms), sample_image_features {k7p_plain:.4f} ms per "
        f"forward")
    log(f"sample_bilinear: 2 calls per bilinear forward, maps "
        f"{[tuple(a[0].shape) for a, _ in k7_op]} at {k7_op[0][0][1].shape[0]}"
        f" positions; max abs err vs plain {k7_abs:.3g}, of scale: bf16 "
        f"{k7_rel[torch.bfloat16]:.3g} (tolerance "
        f"{BILINEAR_TOL[torch.bfloat16]}), f32 {k7_rel[torch.float32]:.3g} "
        f"(tolerance {BILINEAR_TOL[torch.float32]}), each call into its "
        f"column range of a table of the path's width, positions outside "
        f"the map and both check batches included; kernel {k7_ms:.4f} ms ("
        f"launches alone {k7_alone:.4f} ms), plain {k7_plain:.4f} ms, "
        f"F.grid_sample {k7_lib:.4f} ms (alone, by the same graph replay, "
        f"{k7_lib_alone:.4f} ms) per forward; "
        f"bound {k7_bound:.5f} ms by {k7_by} ({k7_bytes} bytes, {k7_ops} "
        f"operations)")

    def zero_counters():
        for fn in all_counters.values():
            fn.launches = 0

    def read_counters(expect, what):
        seen = {n: fn.launches for n, fn in all_counters.items()
                if fn.launches}
        if seen != expect:
            raise AssertionError(f"{what} launched {seen}, expected "
                                 f"{expect}")
        return seen

    n = FLAVOUR_RUNS
    flavour_launches = {}
    default_expect = dict(event_graph_search=n, spline_fused_level0=2 * n,
                          spline_shift_pooled=8 * n, upsample_rows=n,
                          bilinear_sample=3 * n, pool_graph=8 * n)
    base_expect = dict(event_graph_search=n, upsample_rows=n,
                       fused_spline_conv=10 * n, bilinear_sample=3 * n,
                       pool_graph=8 * n)
    # default and base run twice, in mirrored order, so that their batch
    # times can be compared within this call
    for name, bcx, expect in (
            ("default", bc, default_expect),
            ("base", bc_base, base_expect),
            ("bilinear", bc_bil, dict(event_graph_search=n,
                                      spline_fused_level0=2 * n,
                                      spline_shift_pooled=8 * n,
                                      bilinear_sample=5 * n,
                                      pool_graph=8 * n)),
            ("base", bc_base, base_expect),
            ("default", bc, default_expect)):
        zero_counters()
        ts_f, outs_f = [], []
        for i in range(n):
            t0 = time.perf_counter()
            o = model_forward(model, batches[i], bcx, mc, gsc)
            torch.cuda.synchronize()
            ts_f.append(time.perf_counter() - t0)
            outs_f.append(o)
        flavour_launches.setdefault(
            name, read_counters(expect, f"{name} forward"))
        d = 0.0
        for ref, got in zip(cpu_refs_bf16, outs_f):
            v = ref.valid
            if not (torch.equal(v, got.valid.cpu())
                    and bool(torch.isfinite(got.logits).all())):
                raise AssertionError(f"{name}: valid slots differ from CPU, "
                                     f"or logits not finite")
            d = max(d, (ref.logits[v] - got.logits.cpu()[v]).abs().max()
                    .item())
        med_f = sorted(ts_f)[len(ts_f) // 2]
        log(f"{name} flavour: launches over {n} forwards "
            f"{flavour_launches[name]}; GPU vs CPU logits max abs diff "
            f"{d:.3g} over batches 0 and 1 (tolerance {LOGIT_TOL}); median "
            f"{med_f * 1e3:.3f} ms "
            f"per batch, sync bboxes/s {n_boxes / med_f}")
        if not d < LOGIT_TOL:
            raise AssertionError(f"{name}: GPU vs CPU logits differ by {d}")
    records.append(dict(
        name="fused_spline_conv", route="cuda",
        source="eventad_tpu_torch/csrc/spline_fused_single.cu",
        replaces="eventad_tpu/ops/spline_fused.py:62",
        launches=flavour_launches["base"]["fused_spline_conv"],
        max_abs_err=max(k5_err, k5_dense_err), ms=k5_ms,
        launch_ms=sum(k5_alone), dense_launch_ms=sum(k5_dense_alone),
        launch_ms_per_call=k5_alone, plain_ms=k5_plain,
        bound_ms=k5_bound, bound_by=k5_by, library_ms=None))
    records.append(dict(
        name="bilinear_sample", route="cuda",
        source="eventad_tpu_torch/csrc/bilinear_sample.cu",
        replaces="eventad_tpu/ops/bilinear_sample.py:45",
        launches=flavour_launches["bilinear"]["bilinear_sample"],
        max_abs_err=k7_abs, ms=k7_ms, launch_ms=k7_alone,
        plain_ms=k7_plain, bound_ms=k7_bound, bound_by=k7_by,
        library_ms=k7_lib, library_launch_ms=k7_lib_alone,
        pooled_launches=flavour_launches["default"]["bilinear_sample"],
        pooled_ms=k7p_ms, pooled_launch_ms=k7p_alone,
        pooled_plain_ms=k7p_plain, pooled_lookup_err=k7p_err))

    # ---- 8. detection serving ----
    from eventad_tpu_torch.bench_detector import ITERS, WARMUP, bench
    from eventad_tpu_torch.models import detector as mdet
    from eventad_tpu_torch.models.detector import (detector_forward,
                                                   detector_maps,
                                                   init_detector)

    detector, _ = init_detector(cfg, torch.Generator().manual_seed(0), dev)
    with torch.no_grad():
        for _ in range(CALIBRATION_PASSES):
            detector_forward(detector, batches[0], cfg, bc32, training=True)
    cpu_detector, _ = init_detector(cfg, torch.Generator().manual_seed(0),
                                    "cpu")
    cpu_detector.load_state_dict(detector.state_dict())

    def maps_err(maps, ref):
        worst = 0.0
        for scale_maps, scale_ref in zip(maps, ref):
            for m, r in zip(scale_maps, scale_ref):
                if m.shape != r.shape:
                    raise AssertionError(f"map {m.shape} vs {r.shape}")
                r = r.float()
                worst = max(worst, (m.float().cpu() - r).abs().max().item()
                            / max(1.0, r.abs().max().item()))
        return worst

    t0 = time.perf_counter()
    with torch.no_grad():
        cpu_maps, _ = detector_maps(cpu_detector, cpu_batches[0], cfg, bc)
        cpu_maps32, _ = detector_maps(cpu_detector, cpu_batches[0], cfg,
                                      bc32)
        maps32, _ = detector_maps(detector, batches[0], cfg, bc32)
    err32 = maps_err(maps32, cpu_maps32)
    log(f"detector: {sum(p.numel() for p in detector.parameters())} "
        f"parameters, running statistics from {CALIBRATION_PASSES} "
        f"batch-statistics passes (f32) on batch 0; CPU maps (bf16 and "
        f"f32) in {time.perf_counter() - t0:.1f} s; f32 maps GPU vs CPU max "
        f"{err32:.3g} of scale (tolerance {F32_MAP_TOL})")
    if not err32 <= F32_MAP_TOL:
        raise AssertionError(f"f32 detector maps differ from the CPU run "
                             f"by {err32} of their scale")
    n_anchors = sum(nx * ny for nx, ny in bc.grids[2:4])
    for name, bcx, expect in (
            ("default", bc, dict(event_graph_search=1, spline_fused_level0=2,
                                 spline_shift_pooled=18, upsample_rows=1,
                                 bilinear_sample=3, pool_graph=8,
                                 postprocess=1)),
            ("base+bilinear", bc._replace(**BASE, **BILINEAR),
             dict(event_graph_search=1, fused_spline_conv=10,
                  bilinear_sample=5, pool_graph=8, postprocess=1))):
        with torch.no_grad():
            maps, strides = detector_maps(detector, batches[0], cfg, bcx)
        worst = maps_err(maps, cpu_maps)
        zero_counters()
        (dets, decoded), pp_calls = recorded(
            mdet, "postprocess",
            lambda: detector_forward(detector, batches[0], cfg, bcx))
        seen = read_counters(expect, f"detector forward ({name})")
        if name == "default":
            nms_inputs = {"batch": pp_calls[0]}
        if tuple(decoded.shape) != (cfg.batch_size, n_anchors, 7) \
                or decoded.dtype != torch.float32 \
                or not bool(torch.isfinite(decoded).all()):
            raise AssertionError(f"decoded {tuple(decoded.shape)} "
                                 f"{decoded.dtype}, or not finite")
        shapes = {k: tuple(v.shape) for k, v in dets.items()}
        if shapes != dict(boxes=(cfg.batch_size, 64, 4),
                          scores=(cfg.batch_size, 64),
                          labels=(cfg.batch_size, 64),
                          mask=(cfg.batch_size, 64)) \
                or not bool(torch.isfinite(dets["scores"]).all()):
            raise AssertionError(f"detections {shapes}")
        if not worst <= MAP_TOL:
            raise AssertionError(f"detector maps ({name}) differ from the "
                                 f"CPU run by {worst} of their scale")
        dt_det = bench(detector, batches[0], cfg, bcx)
        log(f"detector forward ({name}, bf16): maps vs CPU max "
            f"{worst:.3g} of scale (tolerance {MAP_TOL}); decoded "
            f"{tuple(decoded.shape)} finite, wh up to "
            f"{float(decoded[..., 2:4].max()):.3g} px; "
            f"{int(dets['mask'].sum())} boxes kept of {cfg.batch_size} x "
            f"64; launches per forward {seen}; detector_images_per_sec "
            f"{cfg.batch_size / dt_det} batch_ms {dt_det * 1e3} "
            f"({WARMUP} warm-up, {ITERS} timed, one synchronise) on {smi}")

    # ---- 9. streaming at full width ----
    streaming_phase(dev, smi, cfg, model, cpu_model, bc, mc, gsc, detector,
                    records, zero_counters, read_counters, maps_err,
                    nms_inputs)
    del detector, cpu_detector
    check_postprocess(dev, smi, nms_inputs, records)

    # ---- 10. detector training at full width ----
    detector_training_phase(dev, smi, records, all_counters)

    # ---- 11. the Loader feeding the card, the fixture's metrics ----
    loader_phase(dev, smi, cfg, model, cpu_model, bc, mc, gsc, records,
                 zero_counters, read_counters)

    # ---- 12. the parallel paths ----
    parallel_phase(dev, smi, cfg, model, bc, mc, gsc, records,
                   all_counters)

    # ---- 13. the graph-captured forward, bench and bench_streaming ----
    graph_phase(dev, smi, model, batches[0], cpu_refs_bf16[0], bc, mc, gsc,
                records, all_counters)

    print(json.dumps({"kernels": records}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
