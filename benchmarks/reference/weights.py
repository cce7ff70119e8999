"""Random weights in the reference-format state dict (the upstream
checkpoint's keys and layouts: conv weights OIHW, Linear and GRU weights
``[out, in]``, spline kernels ``[K^2, Cin, Cout]``, the DAGR's keys under
``dagr_model.``), made on a device from a seed in two draws: one normal
and one uniform buffer for every tensor together.

Scales follow the program's initialisation: He-normal ResNet convs and
GRU input weights, uniform ``1/sqrt(fan_in)`` for spline kernels, roots,
skips and Linear layers.  The batch norms get random statistics and
affines near the identity (mean ~ N(0, 0.1), variance 1 + |N(0, 0.1)|), so
that a fault in them shows; the GRU's recurrent weights are normal at
``1/sqrt(H)`` in place of the program's orthogonal ones."""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .geometry import LAYER_SPECS, Geometry
from .model import DAGR

Spec = Tuple[str, tuple, str, float]     # key, shape, kind, scale


def _bn(out: List[Spec], key: str, c: int) -> None:
    out += [(f"{key}.weight", (c,), "one", 0.1),
            (f"{key}.bias", (c,), "normal", 0.1),
            (f"{key}.running_mean", (c,), "normal", 0.1),
            (f"{key}.running_var", (c,), "var", 0.1)]


def specs(geo: Geometry) -> List[Spec]:
    """Every tensor of the model at ``geo``'s widths."""
    out: List[Spec] = []
    ks2 = geo.kernel_size ** 2
    names = ("conv_block1", "layer2", "layer3", "layer4", "layer5")
    for nm, (cin, cout) in zip(names, geo.layer_in_out()):
        base = f"{DAGR}backbone.{nm}"
        for bi, c in ((1, cin), (2, cout)):
            cb = f"{base}.conv_block{bi}"
            out += [(f"{cb}.conv.weight", (ks2, c, cout), "uniform",
                     (c * ks2) ** -0.5),
                    (f"{cb}.conv.lin.weight", (cout, c), "uniform", c ** -0.5)]
            _bn(out, f"{cb}.norm.module", cout)
        out += [(f"{base}.conv_block2.lin.mlp.weight", (cout, cin), "uniform",
                 cin ** -0.5),
                (f"{base}.conv_block2.lin.mlp.bias", (cout,), "uniform",
                 cin ** -0.5)]
        _bn(out, f"{base}.conv_block2.norm_skip.module", cout)
    if geo.use_image:
        r = f"{DAGR}backbone.net.module."
        out.append((r + "conv1.weight", (64, 3, 7, 7), "normal",
                    (2.0 / (3 * 49)) ** 0.5))
        _bn(out, r + "bn1", 64)
        blocks, e = LAYER_SPECS[geo.img_net]
        cin = 64
        for li, (n, planes) in enumerate(zip(blocks, (64, 128, 256, 512)),
                                         start=1):
            for bi in range(n):
                stride = 2 if (li > 1 and bi == 0) else 1
                cout = planes * e
                shapes = ([(planes, cin, 1), (planes, planes, 3),
                           (cout, planes, 1)] if e == 4 else
                          [(planes, cin, 3), (cout, planes, 3)])
                base = f"{r}layer{li}.{bi}"
                for ci, (o, i, k) in enumerate(shapes, start=1):
                    out.append((f"{base}.conv{ci}.weight", (o, i, k, k),
                                "normal", (2.0 / (i * k * k)) ** 0.5))
                    _bn(out, f"{base}.bn{ci}", o)
                if stride != 1 or cin != cout:
                    out.append((f"{base}.downsample.0.weight",
                                (cout, cin, 1, 1), "normal",
                                (2.0 / cin) ** 0.5))
                    _bn(out, f"{base}.downsample.1", cout)
                cin = cout
        p = f"{DAGR}backbone.net.feature_dconv."
        for i, (ci, co) in enumerate(zip(geo.tap_channels(),
                                         geo.channels()[1:])):
            out += [(f"{p}{i}.weight", (co, ci, 1, 1), "uniform", ci ** -0.5),
                    (f"{p}{i}.bias", (co,), "uniform", ci ** -0.5)]
    for key, (i, o) in (("event_proj", (geo.h_dim, 256)),
                        ("coord_proj", (geo.coord_dim, 256)),
                        ("fusion.0", (512, 256)), ("fusion.3", (256, 2))):
        out += [(f"fusion_module.{key}.weight", (o, i), "uniform", i ** -0.5),
                (f"fusion_module.{key}.bias", (o,), "uniform", i ** -0.5)]
    out += [("soft_attention.weight", (geo.h_dim, 1), "normal",
             (2.0 / 6 / geo.h_dim) ** 0.5),
            ("soft_attention_cor.weight", (geo.coord_dim, 1), "normal",
             (2.0 / 6 / geo.coord_dim) ** 0.5)]
    for prefix, inp, hid, layers in (
            ("gru_net_event.gru", geo.x_dim, geo.h_dim, geo.event_layers),
            ("gru_net_cor.gru", 4, geo.coord_dim, geo.coord_layers)):
        for li in range(layers):
            i = inp if li == 0 else hid
            out += [(f"{prefix}.weight_ih_l{li}", (3 * hid, i), "normal",
                     (2.0 / i) ** 0.5),
                    (f"{prefix}.weight_hh_l{li}", (3 * hid, hid), "normal",
                     hid ** -0.5),
                    (f"{prefix}.bias_ih_l{li}", (3 * hid,), "uniform", 0.05),
                    (f"{prefix}.bias_hh_l{li}", (3 * hid,), "uniform", 0.05)]
    return out


def make_state(geo: Geometry, seed: int, device) -> Dict[str, torch.Tensor]:
    """The state dict of ``geo``'s model, f32 on ``device``, from
    ``seed``: every tensor a slice of one normal and one uniform draw."""
    sp = specs(geo)
    sizes = [int(torch.Size(shape).numel()) for _, shape, _, _ in sp]
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(sizes)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, off = {}, 0
    for (key, shape, kind, s), n in zip(sp, sizes):
        nrm = normal[off:off + n].view(shape)
        uni = uniform[off:off + n].view(shape)
        off += n
        if kind == "normal":
            t = nrm * s
        elif kind == "uniform":
            t = uni * s
        elif kind == "one":
            t = 1.0 + nrm * s
        else:                                   # a variance
            t = 1.0 + (nrm * s).abs()
        out[key] = t.contiguous()
    return out


def split(sd: Dict[str, torch.Tensor]):
    """``(dagr_sd, head_sd)``: the DAGR's keys without their prefix, the
    head's as they are."""
    n = len(DAGR)
    return ({k[n:]: v for k, v in sd.items() if k.startswith(DAGR)},
            {k: v for k, v in sd.items() if not k.startswith(DAGR)})
