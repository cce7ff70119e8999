"""Frozen counts: the analytic FLOPs and minimum bytes of the scoring
forward (a copy of ``eventad_tpu_torch/utils/roofline.forward_roofline``
and its helpers), the incremental streaming FLOPs (``utils/flops`` and
``streaming/evaluate.flops_report``), and ``chip_smoke.py``'s per-kernel
bound rule (every input read once, every output written once, only what
an edge touches), which turns a hand-written kernel's arguments into the
least time the card could take for it.

The H100 SXM's published dense peaks at 700 W (NVIDIA's data sheet)."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..reference.geometry import FEATURE_LAYERS, LAYER_SPECS, Geometry

PEAK_BF16 = 989e12    # tensor cores, dense
PEAK_F32 = 67e12      # outside the tensor cores (integer work counted here)
HBM_BYTES_PER_S = 3.35e12
OUTPUT_LAYERS = ("layer3", "layer4")


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


# ---------------------------------------------------------------------------
# the scoring forward (utils/roofline.py)
# ---------------------------------------------------------------------------
def resnet_conv_list(arch: str, h: int, w: int
                     ) -> Tuple[List[tuple], Dict[str, tuple]]:
    """Every conv of the ResNet as ``(kh, kw, cin, cout, ho, wo)``, and the
    tap dims ``(channels, ho, wo)`` per feature layer."""
    blocks, expansion = LAYER_SPECS[arch]
    convs = []
    ho, wo = _ceil_div(h, 2), _ceil_div(w, 2)
    convs.append((7, 7, 3, 64, ho, wo))
    taps = {"conv1": (64, ho, wo)}
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
                convs.append((1, 1, cin, planes, hi, wi))
                convs.append((3, 3, planes, planes, ho, wo))
                convs.append((1, 1, planes, cout, ho, wo))
            else:
                convs.append((3, 3, cin, planes, ho, wo))
                convs.append((3, 3, planes, cout, ho, wo))
            if stride != 1 or cin != cout:
                convs.append((1, 1, cin, cout, ho, wo))
            cin = cout
        taps[f"layer{li+1}"] = (cin, ho, wo)
    return convs, taps


def cnn_branch_cost(arch: str, b: int, h: int, w: int,
                    feature_channels, output_channels, dsize: int):
    """``(flops, bytes)`` of the CNN branch at batch ``b``."""
    convs, taps = resnet_conv_list(arch, h, w)
    for i, layer in enumerate(FEATURE_LAYERS):
        c, ho, wo = taps[layer]
        convs.append((1, 1, c, feature_channels[i], ho, wo))
    for i, layer in enumerate(OUTPUT_LAYERS):
        c, ho, wo = taps[layer]
        convs.append((1, 1, c, output_channels[i], ho, wo))
    flops = 0.0
    bytes_ = float(b * h * w * 3 * 4)
    for (kh, kw, cin, cout, ho, wo) in convs:
        flops += 2.0 * b * ho * wo * kh * kw * cin * cout
        bytes_ += dsize * (2.0 * b * ho * wo * cout + kh * kw * cin * cout)
    return flops, bytes_


def spline_conv_cost(n_nodes: int, n_edges: int, cin: int, cout: int,
                     kernel_size: int, dsize: int):
    """Model flops and bytes of one spline conv in the basis-decomposed
    form."""
    m = kernel_size * kernel_size
    flops = (2.0 * n_edges * 4 * cin
             + 2.0 * n_nodes * m * cin * cout
             + 2.0 * n_nodes * cin * cout)
    bytes_ = dsize * (n_nodes * (cin + cout)
                      + n_edges * cin
                      + (m + 1) * cin * cout)
    return flops, bytes_


def forward_roofline(geo: Geometry, n_events: int,
                     compute_dtype: str) -> dict:
    """Analytic ``flops`` and minimum ``bytes`` of one batched scoring
    forward at ``n_events`` per item (the batch's bucket), with the
    per-stage breakdown ``stages`` ``{stage: (flops, bytes)}``."""
    dsize = 2 if compute_dtype == "bfloat16" else 4
    b = geo.batch_size
    w, h = geo.model_width, geo.model_height
    n = n_events
    nb = b * n
    ch = geo.channels()
    img_ch = list(ch[1:]) if geo.use_image else [0] * 5
    grids = geo.grid_dims()
    k = geo.max_neighbors
    ks = geo.kernel_size
    stages: Dict[str, Tuple[float, float]] = {}
    if geo.use_image:
        stages["cnn"] = cnn_branch_cost(geo.img_net, b, h, w, img_ch,
                                        [256, 256], dsize)
        c01 = img_ch[0] + img_ch[1]
        stages["image_upsample_gather"] = (
            2.0 * b * h * w * c01 * 4,
            dsize * (b * h * w * c01 * 2 + nb * c01))
    lb = min(geo.graph_lookback, n)
    stages["graph_search"] = (4.0 * nb * lb,
                              4.0 * nb + nb * k * (4 + 1 + 2))
    pairs = [(ch[i] + img_ch[i] + 2, ch[i + 1]) for i in range(5)]
    nodes = nb
    fl = by = 0.0
    for li, (cin, cout) in enumerate(pairs):
        if li > 0:
            nx, ny = grids[li - 1]
            new_nodes = b * nx * ny
            by += dsize * (nodes * cin + new_nodes * cin)
            nodes = new_nodes
        edges = nodes * (k - 1 if li == 0 else (2 * 2 + 1) ** 2)
        f1, b1 = spline_conv_cost(nodes, edges, cin, cout, ks, dsize)
        f2, b2 = spline_conv_cost(nodes, edges, cout, cout, ks, dsize)
        fl += f1 + f2 + 2.0 * nodes * cin * cout
        by += b1 + b2 + dsize * (nodes * cout + cin * cout)
    stages["gnn_pyramid"] = (fl, by)
    s1 = geo.max_boxes + 1
    n4 = b * grids[3][0] * grids[3][1]
    x_dim, h_dim = geo.x_dim, geo.h_dim
    head_fl = (2.0 * n4 * s1 * 4
               + 2 * b * s1 * (3 * (x_dim + h_dim) * h_dim
                               + 3 * (h_dim + h_dim) * h_dim
                               + 3 * (4 + 32) * 32
                               + 2 * (h_dim + 32) * 256 + 256 * 2))
    stages["box_head"] = (head_fl, 4.0 * (b * s1 * (x_dim + 4 + 2)
                                          + n4 * x_dim))
    return {"flops": sum(f for f, _ in stages.values()),
            "bytes": sum(x for _, x in stages.values()),
            "stages": stages}


# ---------------------------------------------------------------------------
# the incremental streaming step (utils/flops.py, flops_report)
# ---------------------------------------------------------------------------
def spline_conv_flops(n_edges: int, cin: int, cout: int,
                      kernel_size: int = 5, n_nodes: int = 0,
                      basis_support: int = 4) -> float:
    m = kernel_size * kernel_size
    return (2.0 * n_edges * basis_support * cin
            + 2.0 * n_nodes * m * cin * cout
            + 2.0 * n_nodes * cin * cout)


def backbone_flops(geo: Geometry, n_events: int, avg_degree: float = 12.0,
                   streaming_changed: int = 0, batch: int = 1) -> float:
    """FLOPs of the GNN pyramid at ``n_events`` level-0 nodes over
    ``batch`` items; ``streaming_changed > 0`` counts an incremental update
    touching that many level-0 nodes instead of a dense pass."""
    total = 0.0
    grids = geo.grid_dims()
    n_nodes = n_events
    changed = streaming_changed
    for li, (cin, cout) in enumerate(geo.layer_in_out()):
        edges = n_nodes * avg_degree
        for c_in in (cin, cout):
            if streaming_changed > 0:
                total += spline_conv_flops(int(changed * avg_degree), c_in,
                                           cout, geo.kernel_size,
                                           n_nodes=changed)
            else:
                total += spline_conv_flops(int(edges), c_in, cout,
                                           geo.kernel_size, n_nodes=n_nodes)
        total += 2.0 * n_nodes * cin * cout
        if li < 4:
            nx, ny = grids[li]
            n_nodes = min(n_nodes, batch * nx * ny)
            changed = min(changed, n_nodes)
    return total


# ---------------------------------------------------------------------------
# chip_smoke.py's per-kernel bound rule, on a kernel wrapper's (args,
# kwargs, result)
# ---------------------------------------------------------------------------
def tensor_bytes(obj) -> int:
    """Bytes of every tensor in a (nested) argument or result."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(tensor_bytes(v) for v in obj.values())
    if isinstance(obj, (tuple, list)):
        return sum(tensor_bytes(v) for v in obj)
    return 0


def all_bytes(a, kw, out) -> int:
    """Every tensor among the arguments read once, the result written."""
    return tensor_bytes(a) + tensor_bytes(kw) + tensor_bytes(out)


def search_ops(a, kw, out):
    """K1: six integer operations for every candidate this data makes a
    destination examine: the valid events of its item at most delta_t
    before it, within the lookback."""
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


def gather_ops(a, kw, out):
    """K6a moves rows and computes nothing."""
    return 0, PEAK_F32


def level0_bytes(a, kw, out) -> int:
    """K2: the source rows, the neighbour table, coordinates only of the
    slots that hold an edge, the node mask, of each pack the values of its
    used taps, root and skip and its affines, both outputs."""
    src, prep, pack1, pack2, node_mask = a
    packs = sum(((pk.taps.shape[0] + 1) * pk.c + pk.cs) * pk.o
                * pk.taps.element_size()
                + pk.o * 4 * pk.ab.element_size() for pk in (pack1, pack2))
    return (tensor_bytes((src, prep.nbr, node_mask, out)) + packs
            + int((prep.nbr >= 0).sum()) * 2 * prep.u.element_size())


def shift_bytes(a, kw, out) -> int:
    """K3: the source rows, the edge mask in full and the node mask,
    coordinates only of the slots that hold an edge, the static offset and
    tap lists, of the weights the used taps, root, the affines and the skip
    operands, and the output."""
    src, prep, weight, root, scale, offset = a
    return (tensor_bytes((src, prep.mq, prep.node_mask, prep.d_offs,
                          prep.tap_mxy, prep.tap_ptr, prep.tap_slots, root,
                          scale, offset, kw.get("skip"), out))
            + int(prep.mq.sum()) * 2 * prep.u.element_size()
            + prep.tap_idx.shape[0] * weight[0].numel()
            * weight.element_size())


def gather_bytes(a, kw, out) -> int:
    """K6a: the mask whole, ``nbr`` only at its edges, each source row an
    edge points to once, and the output."""
    src, nbr, mask = a
    c = src.shape[1]
    edges = int(mask.sum())
    rows_read = int(torch.unique(nbr[mask]).numel())
    return (tensor_bytes(mask) + edges * nbr.element_size()
            + rows_read * c * src.element_size()
            + mask.numel() * c * src.element_size())


# kernel -> (operations, bytes) of one wrapper call
RULES = {
    "K1": (search_ops, all_bytes),
    "K2": (level0_ops, level0_bytes),
    "K3": (shift_ops, shift_bytes),
    "K4": (upsample_ops, all_bytes),
    "K6a": (gather_ops, gather_bytes),
}


def bound_seconds(kernel: str, a, kw, out) -> float:
    """The least time the card could take for one call of ``kernel`` on
    these arguments: the larger of its bytes over the memory rate and its
    operations over their peak rate."""
    ops_fn, bytes_fn = RULES[kernel]
    ops, peak = ops_fn(a, kw, out)
    return max(bytes_fn(a, kw, out) / HBM_BYTES_PER_S, ops / peak)
