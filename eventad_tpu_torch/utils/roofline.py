"""Analytic roofline accounting for the batched scoring forward (a copy of
``eventad_tpu/utils/roofline.py``'s counts, with the H100's peaks).

Both roofline numerators come from the model architecture, not from a
profiler or a compiler's cost model, so the count is the same whatever
implements each stage (a hand-written kernel, cuDNN, plain PyTorch):

- ``flops``: *model* FLOPs, the algorithmic multiply-add count of the
  network (the standard MFU numerator).  Work a kernel adds on top (padding
  lanes, masked slots) is excluded: MFU answers "what share of the peak went
  into the model's math".
- ``bytes``: the *minimum* HBM traffic: every activation written once and
  read once by its consumer, weights read once, gathers counted at their
  logical volume (the rows actually fetched).  Real traffic is at least
  this, so ``bytes / time`` is a lower bound on the achieved bandwidth and
  must come out under the card's peak.

Peaks: NVIDIA H100 SXM, the data sheet's dense rates without sparsity, which
hold at the card's full 700 W power limit: 989 TFLOP/s bf16 on the tensor
cores, 495 TFLOP/s TF32, 67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s
HBM.  :func:`roofline_rates` divides by the peak of the run's compute
dtype: bf16 for a bf16 run; for an f32 run TF32 when
``torch.backends.cudnn.allow_tf32`` is on (PyTorch's default, which the
bench keeps: the ResNet's convolutions, nine tenths of the FLOPs, then run
on the tensor cores) and the f32 peak when it is off (as the parallel entry
modules set it, ``parallel/mesh.process_mesh``).  The record names the peak
it used (``mfu_peak_tflops``).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

H100_PEAK_FLOPS_BF16 = 989e12
H100_PEAK_FLOPS_TF32 = 495e12
H100_PEAK_FLOPS_F32 = 67e12
H100_PEAK_HBM = 3.35e12     # bytes/s


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# CNN branch (ResNet + 1x1 remaps, models/resnet.py)
# ---------------------------------------------------------------------------
def resnet_conv_list(arch: str, h: int, w: int
                     ) -> Tuple[List[tuple], Dict[str, tuple]]:
    """Every conv of the ResNet as ``(kh, kw, cin, cout, ho, wo)``, and the
    tap dims ``(channels, ho, wo)`` per feature layer."""
    from ..models.resnet import LAYER_SPECS
    blocks, expansion = LAYER_SPECS[arch]
    convs = []
    # stem: 7x7 s2
    ho, wo = _ceil_div(h, 2), _ceil_div(w, 2)
    convs.append((7, 7, 3, 64, ho, wo))
    taps = {"conv1": (64, ho, wo)}
    # maxpool s2
    ho, wo = _ceil_div(ho, 2), _ceil_div(wo, 2)
    cin = 64
    for li, (n, planes) in enumerate(zip(blocks, [64, 128, 256, 512])):
        for bi in range(n):
            stride = 2 if (li > 0 and bi == 0) else 1
            cout = planes * expansion
            if stride == 2:
                ho, wo = _ceil_div(ho, 2), _ceil_div(wo, 2)
            if expansion == 4:
                hi, wi = (ho * stride, wo * stride) if stride == 2 \
                    else (ho, wo)
                convs.append((1, 1, cin, planes, hi, wi))      # c1 pre-stride
                convs.append((3, 3, planes, planes, ho, wo))   # c2 (strided)
                convs.append((1, 1, planes, cout, ho, wo))     # c3
            else:
                convs.append((3, 3, cin, planes, ho, wo))
                convs.append((3, 3, planes, cout, ho, wo))
            if stride != 1 or cin != cout:
                convs.append((1, 1, cin, cout, ho, wo))        # downsample
            cin = cout
        taps[f"layer{li+1}"] = (cin, ho, wo)
    return convs, taps


def cnn_branch_cost(arch: str, b: int, h: int, w: int,
                    feature_channels, output_channels, dsize: int):
    """``(flops, bytes)`` of the CNN branch at batch ``b``."""
    from ..models.resnet import FEATURE_LAYERS, OUTPUT_LAYERS
    convs, taps = resnet_conv_list(arch, h, w)
    for i, l in enumerate(FEATURE_LAYERS):
        c, ho, wo = taps[l]
        convs.append((1, 1, c, feature_channels[i], ho, wo))
    for i, l in enumerate(OUTPUT_LAYERS):
        c, ho, wo = taps[l]
        convs.append((1, 1, c, output_channels[i], ho, wo))
    flops = 0.0
    bytes_ = float(b * h * w * 3 * 4)       # input image read (f32)
    for (kh, kw, cin, cout, ho, wo) in convs:
        flops += 2.0 * b * ho * wo * kh * kw * cin * cout
        # each conv output is written once and read once by its consumer
        # (2x out bytes); inputs are the producers' outputs, already counted
        bytes_ += dsize * (2.0 * b * ho * wo * cout
                           + kh * kw * cin * cout)     # weights
    return flops, bytes_


# ---------------------------------------------------------------------------
# GNN backbone + head
# ---------------------------------------------------------------------------
def spline_conv_cost(n_nodes: int, n_edges: int, cin: int, cout: int,
                     kernel_size: int, dsize: int):
    """Model flops of one spline conv in the basis-decomposed form
    (``utils/flops.spline_conv_flops``): per-edge 4-tap basis mixing, per
    node the ``k^2``-tap weighted sum times the kernel, plus the root
    linear.  Bytes: node features in and out once, the logical gather
    volume (neighbour rows actually combined) and the kernel weights."""
    m = kernel_size * kernel_size
    flops = (2.0 * n_edges * 4 * cin                 # basis-weighted taps
             + 2.0 * n_nodes * m * cin * cout        # kernel matmul
             + 2.0 * n_nodes * cin * cout)           # root linear
    bytes_ = dsize * (n_nodes * (cin + cout)         # x in / out
                      + n_edges * cin                # gathered rows (logical)
                      + (m + 1) * cin * cout)        # weights
    return flops, bytes_


def forward_roofline(cfg, n_events: int = None) -> dict:
    """Analytic ``(flops, min-bytes)`` of the batched scoring forward of
    ``cfg`` (the port's :class:`~eventad_tpu_torch.config.Config`) at
    ``n_events`` per item (default: the largest bucket).  Returns the
    totals, a per-stage breakdown ``{stage: (GFLOP, MB)}`` and the totals
    in GFLOP and GB.

    Approximations (all stated, all conservative for the roofline claim):
    gathers and scatters at their logical row volume; elementwise, BN and
    activation ops folded into their producer's bytes with their flops
    ignored (under 1 % of the total); the neighbour search's compares
    counted as 4 operations a candidate over the lookback window."""
    dsize = 2 if cfg.compute_dtype == "bfloat16" else 4
    b = cfg.batch_size
    w, h = cfg.model_width, cfg.model_height
    n = n_events if n_events is not None else cfg.event_buckets[-1]
    nb = b * n
    ch = cfg.channels()
    img_ch = list(ch[1:]) if cfg.use_image else [0] * 5
    grids = cfg.grid_dims()
    k = cfg.max_neighbors
    ks = cfg.kernel_size
    stages: Dict[str, Tuple[float, float]] = {}

    if cfg.use_image:
        stages["cnn"] = cnn_branch_cost(cfg.img_net, b, h, w,
                                        img_ch, [256, 256], dsize)
        # maps 0/1 upsampled to full resolution (4-tap bilinear), written
        # once, then one combined row gather at the event positions
        c01 = img_ch[0] + img_ch[1]
        up_flops = 2.0 * b * h * w * c01 * 4
        up_bytes = dsize * (b * h * w * c01 * 2      # write + gather-read
                            + nb * c01)              # rows delivered
        stages["image_upsample_gather"] = (up_flops, up_bytes)

    # level-0 neighbour search: each destination scans the lookback window
    # of packed keys
    lb = min(cfg.graph_lookback, n)
    stages["graph_search"] = (4.0 * nb * lb,
                              4.0 * nb            # packed keys read
                              + nb * k * (4 + 1 + 2))  # nbr/mask/off out

    # GNN pyramid: layer 1 at event scale, layers 2-5 on pooled cell tables
    pairs = [(ch[i] + img_ch[i] + 2, ch[i + 1]) for i in range(5)]
    nodes = nb
    fl = by = 0.0
    for li, (cin, cout) in enumerate(pairs):
        if li > 0:
            nx, ny = grids[li - 1]
            new_nodes = b * nx * ny
            # pooling: scatter rows into the cell table + position snap
            by += dsize * (nodes * cin + new_nodes * cin)
            nodes = new_nodes
        edges = nodes * (k - 1 if li == 0 else (2 * 2 + 1) ** 2)
        f1, b1 = spline_conv_cost(nodes, edges, cin, cout, ks, dsize)
        f2, b2 = spline_conv_cost(nodes, edges, cout, cout, ks, dsize)
        fskip = 2.0 * nodes * cin * cout
        fl += f1 + f2 + fskip
        by += b1 + b2 + dsize * (nodes * cout + cin * cout)
    stages["gnn_pyramid"] = (fl, by)

    # box feature pooling + recurrent head (f32, tiny)
    s1 = cfg.max_boxes + 1
    n4 = b * grids[3][0] * grids[3][1]
    x_dim, h_dim = cfg.x_dim, cfg.h_dim
    head_fl = (2.0 * n4 * s1 * 4                       # in-box tests
               + 2 * b * s1 * (3 * (x_dim + h_dim) * h_dim
                               + 3 * (h_dim + h_dim) * h_dim   # 2-layer GRU
                               + 3 * (4 + 32) * 32             # coord GRU
                               + 2 * (h_dim + 32) * 256 + 256 * 2))
    stages["box_head"] = (head_fl, 4.0 * (b * s1 * (x_dim + 4 + 2)
                                          + n4 * x_dim))

    flops = sum(f for f, _ in stages.values())
    bytes_ = sum(bb for _, bb in stages.values())
    return {
        "flops": flops,
        "bytes": bytes_,
        "by_stage": {k_: (round(f / 1e9, 3), round(bb / 1e6, 2))
                     for k_, (f, bb) in stages.items()},
        "gflops": round(flops / 1e9, 2),
        "gbytes": round(bytes_ / 1e9, 4),
    }


def roofline_rates(roof: dict, device_seconds: float, device_name: str,
                   compute_dtype: str = "bfloat16") -> dict:
    """MFU and achieved-bandwidth view of ``roof`` over ``device_seconds``
    per batch on the card ``device_name`` (``torch.cuda.get_device_name``),
    with the least time the card could take (``roofline_bound_ms``: the
    larger of bytes over the HBM peak and flops over the FLOP peak).
    Flags, rather than prints silently, a physically impossible rate
    (``roofline_warning``).  Raises for a card other than an H100: its
    peaks are the only ones known here."""
    if "H100" not in device_name:
        raise ValueError(f"roofline_rates: the peaks are an H100's; the "
                         f"card is {device_name!r}")
    # the peak of the run's compute dtype: bf16; for f32 TF32 while cuDNN
    # may use it, else f32
    if compute_dtype == "bfloat16":
        peak = H100_PEAK_FLOPS_BF16
    elif torch.backends.cudnn.allow_tf32:
        peak = H100_PEAK_FLOPS_TF32
    else:
        peak = H100_PEAK_FLOPS_F32
    mfu = roof["flops"] / device_seconds / peak
    hbm = roof["bytes"] / device_seconds
    out = {
        "mfu": mfu,
        "mfu_peak_tflops": peak / 1e12,
        "hbm_gbps_min": hbm / 1e9,
        "roofline_bound_ms": max(roof["bytes"] / H100_PEAK_HBM,
                                 roof["flops"] / peak) * 1e3,
    }
    if mfu > 1.0 or hbm > H100_PEAK_HBM:
        out["roofline_warning"] = (
            f"impossible rate: mfu={mfu:.3f} hbm={hbm/1e9:.0f}GB/s exceeds "
            f"the H100's peaks ({peak/1e12:.0f} TFLOP/s, "
            f"{H100_PEAK_HBM/1e12:.2f} TB/s): accounting or timing bug")
    return out
