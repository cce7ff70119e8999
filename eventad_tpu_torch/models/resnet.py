"""ResNet feature-pyramid CNN branch, eval mode (counterpart of
``eventad_tpu/models/resnet.py``).

The reference wraps torchvision's ResNet-50 in ``HookModule``
(net_img.py:42-135): hooks capture ``conv1`` (pre-BN) and ``layer1..layer4``,
each remapped by a 1x1 conv (``feature_dconv``).  Built here from
``LAYER_SPECS`` with ``torch.nn.functional.conv2d``; maps are NHWC at the
public functions, as in the JAX package.  The two ``output_dconv`` maps
(remaps of ``layer3`` and ``layer4``) feed the detector's CNN head; a branch
built without ``output_channels`` has no such convs, and the scoring path
computes only the five feature maps.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.norm import BatchNorm
from ..utils.tensors import frozen_operands

LAYER_SPECS = {
    "resnet18": ([2, 2, 2, 2], 1),
    "resnet34": ([3, 4, 6, 3], 1),
    "resnet50": ([3, 4, 6, 3], 4),
}
FEATURE_LAYERS = ("conv1", "layer1", "layer2", "layer3", "layer4")
OUTPUT_LAYERS = ("layer3", "layer4")


def tap_channels(arch: str) -> List[int]:
    _, e = LAYER_SPECS[arch]
    base = {"conv1": 64, "layer1": 64 * e, "layer2": 128 * e,
            "layer3": 256 * e, "layer4": 512 * e}
    return [base[l] for l in FEATURE_LAYERS]


def _conv_weight(cout, cin, kh, kw, generator):
    std = (2.0 / (kh * kw * cin)) ** 0.5
    return nn.Parameter(torch.randn(cout, cin, kh, kw, generator=generator)
                        * std)


class Block(nn.Module):
    """Bottleneck (expansion 4) or basic block; conv weights OIHW."""

    def __init__(self, cin, planes, expansion, stride, generator):
        super().__init__()
        cout = planes * expansion
        self.stride = stride
        if expansion == 4:
            shapes = [(planes, cin, 1), (planes, planes, 3), (cout, planes, 1)]
        else:
            shapes = [(planes, cin, 3), (cout, planes, 3)]
        self.convs = nn.ParameterList(
            [_conv_weight(o, i, k, k, generator) for o, i, k in shapes])
        self.bns = nn.ModuleList([BatchNorm(o) for o, _, _ in shapes])
        self.down = self.down_bn = None
        if stride != 1 or cin != cout:
            self.down = _conv_weight(cout, cin, 1, 1, generator)
            self.down_bn = BatchNorm(cout)


class CNNBranch(nn.Module):
    """ResNet + the HookModule's 1x1 feature remaps (net_img.py:70-90)."""

    def __init__(self, arch: str, feature_channels: List[int],
                 generator: torch.Generator = None, in_channels: int = 3,
                 output_channels: Sequence[int] = ()):
        super().__init__()
        blocks, expansion = LAYER_SPECS[arch]
        self.arch = arch
        self.conv1 = _conv_weight(64, in_channels, 7, 7, generator)
        self.bn1 = BatchNorm(64)
        layers, cin = [], 64
        for li, (n, planes) in enumerate(zip(blocks, [64, 128, 256, 512])):
            layer = nn.ModuleList()
            for bi in range(n):
                stride = 2 if (li > 0 and bi == 0) else 1
                layer.append(Block(cin, planes, expansion, stride, generator))
                cin = planes * expansion
            layers.append(layer)
        self.layers = nn.ModuleList(layers)
        self.feature_w = nn.ParameterList()
        self.feature_b = nn.ParameterList()
        for ci, co in zip(tap_channels(arch), feature_channels):
            s = 1.0 / ci ** 0.5
            w = torch.empty(co, ci, 1, 1).uniform_(-s, s, generator=generator)
            b = torch.empty(co).uniform_(-s, s, generator=generator)
            self.feature_w.append(nn.Parameter(w))
            self.feature_b.append(nn.Parameter(b))
        self.output_w = nn.ParameterList()
        self.output_b = nn.ParameterList()
        taps = dict(zip(FEATURE_LAYERS, tap_channels(arch)))
        for layer, co in zip(OUTPUT_LAYERS, output_channels):
            ci = taps[layer]
            s = 1.0 / ci ** 0.5
            w = torch.empty(co, ci, 1, 1).uniform_(-s, s, generator=generator)
            b = torch.empty(co).uniform_(-s, s, generator=generator)
            self.output_w.append(nn.Parameter(w))
            self.output_b.append(nn.Parameter(b))


def _bn_fold(bn: BatchNorm, dt: torch.dtype, eps: float = 1e-5):
    """Eval BN on NCHW as the affine ``(a, b)``, each ``[C, 1, 1]`` in
    ``dt``, folded in f32 from the parameters in ``dt`` and the f32 running
    statistics; applied as ``x * a + b``."""
    a = bn.scale.to(dt).float() * torch.rsqrt(bn.var.float() + eps)
    b = bn.offset.to(dt).float() - bn.mean.float() * a
    return a.to(dt)[:, None, None], b.to(dt)[:, None, None]


def branch_operands(cnn: CNNBranch, dt: torch.dtype):
    """What :func:`cnn_branch_forward` takes from ``cnn`` in compute dtype
    ``dt``: ``(stem, blocks, feature remaps, output remaps)``, the stem
    ``(weight, a, b)``, each block ``(convs, down)`` with a ``(weight, a,
    b)`` per conv and BN (``down`` None without one), each remap ``(weight,
    bias [C, 1, 1])``; weights and biases cast to ``dt``, each BN folded by
    :func:`_bn_fold`.  Kept on the branch (``utils/tensors.frozen_operands``,
    one entry for every tensor of the branch), so a forward with unchanged
    weights casts and folds nothing."""
    def bn_tensors(bn):
        return [bn.scale, bn.offset, bn.mean, bn.var]

    # the sources named one by one: walking the module tree (parameters(),
    # buffers()) costs more than reading the list
    sources = [cnn.conv1, *bn_tensors(cnn.bn1)]
    for layer in cnn.layers:
        for blk in layer:
            sources += blk.convs
            for bn in blk.bns:
                sources += bn_tensors(bn)
            if blk.down is not None:
                sources += [blk.down, *bn_tensors(blk.down_bn)]
    sources += [*cnn.feature_w, *cnn.feature_b, *cnn.output_w,
                *cnn.output_b]

    def make():
        def remap(ws, bs):
            return [(w.to(dt), b.to(dt)[:, None, None])
                    for w, b in zip(ws, bs)]
        blocks = [([(w.to(dt), *_bn_fold(bn, dt))
                    for w, bn in zip(blk.convs, blk.bns)],
                   None if blk.down is None else
                   (blk.down.to(dt), *_bn_fold(blk.down_bn, dt)))
                  for layer in cnn.layers for blk in layer]
        return ((cnn.conv1.to(dt), *_bn_fold(cnn.bn1, dt)), blocks,
                remap(cnn.feature_w, cnn.feature_b),
                remap(cnn.output_w, cnn.output_b))
    return frozen_operands(cnn, "branch_operands", sources, make, key=(dt,))


def _conv_bn(x, w, a, b, stride=1):
    return F.conv2d(x, w, stride=stride,
                    padding=(w.shape[2] - 1) // 2) * a + b


def _block_forward(x, blk: Block, convs, down):
    h = x
    n = len(convs)
    for i, (w, a, b) in enumerate(convs):
        # bottleneck: stride on the 3x3 (i == 1); basic: on the first conv
        stride = blk.stride if i == (1 if n == 3 else 0) else 1
        h = _conv_bn(h, w, a, b, stride)
        if i < n - 1:
            h = torch.relu(h)
    identity = x
    if down is not None:
        identity = _conv_bn(x, *down, blk.stride)
    return torch.relu(h + identity)


def cnn_branch_forward(cnn: CNNBranch, image: torch.Tensor,
                       compute_dtype: str = "float32", *,
                       outputs: bool = False):
    """``image [B, H, W, 3]`` in [0, 1] -> the five remapped feature maps,
    NHWC; with ``outputs`` the pair ``(features, output maps)``, the two
    ``output_dconv`` maps beside them.  ``compute_dtype="bfloat16"`` casts
    weights and activations; BN running statistics stay f32 inside the
    folded affine (:func:`branch_operands`)."""
    dt = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    (w1, a1, b1), blocks, feature_maps, output_maps = branch_operands(cnn,
                                                                      dt)
    x = image.to(dt).permute(0, 3, 1, 2)
    h = F.conv2d(x, w1, stride=2, padding=3)
    taps = [h]                       # the hook fires on conv1 (pre-BN)
    h = torch.relu(h * a1 + b1)
    h = F.max_pool2d(h, 3, 2, padding=1)
    ops = iter(blocks)
    for layer in cnn.layers:
        for blk in layer:
            h = _block_forward(h, blk, *next(ops))
        taps.append(h)

    def remap(t, w, b):
        f = F.conv2d(t, w) + b
        return f.permute(0, 2, 3, 1).contiguous()

    feats = [remap(t, w, b) for t, (w, b) in zip(taps, feature_maps)]
    if not outputs:
        return feats
    by_layer = dict(zip(FEATURE_LAYERS, taps))
    return feats, [remap(by_layer[layer], w, b)
                   for layer, (w, b) in zip(OUTPUT_LAYERS, output_maps)]
