"""The frozen forward's prepared operands (``utils/tensors.frozen_operands``)
and the head's stateless work run once a batch, against the per-call
formulations they replaced, copied here as they stood: the ResNet's
per-BN fold and per-call weight casts, the eval ``batch_norm``'s per-call
affine, the spline conv's per-call gather, fold and index copy, and the
head's per-item loop with the fusion, the cross entropy and the GRUs'
first input projections inside it.  The prepared operands give the same
bits; the batched head lies within f32 GEMM reordering and keeps the
training path's dropout draws in order.  Operands kept on a module follow
in-place updates of its weights and statistics, and operation counts hold
the preparation out of the forward.  Small shapes; nothing of JAX is
used."""
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from eventad_tpu_torch.config import Config
from eventad_tpu_torch.data.synthetic import make_synthetic_batch
from eventad_tpu_torch.models.dagr import (graph_static_config, init_model,
                                           model_forward)
from eventad_tpu_torch.models.eventad import (EventADConfig, EventADHead,
                                              eventad_forward,
                                              spatial_attention)
from eventad_tpu_torch.models.gru import gru_input, gru_step
from eventad_tpu_torch.models.resnet import CNNBranch, cnn_branch_forward
from eventad_tpu_torch.ops.norm import BatchNorm, batch_norm
from eventad_tpu_torch.ops.spline_conv import (SplineConv, center_index,
                                               spline_coeff_sep, spline_conv,
                                               sub_kernel_index, tap_ranges)
from eventad_tpu_torch.utils.ema import ema_init, ema_weights

import _torch_threads  # noqa: F401  (one intra-op thread)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _randomise_bn(bn: BatchNorm, g: torch.Generator):
    c = bn.scale.shape[0]
    with torch.no_grad():
        bn.scale.copy_(0.5 + torch.rand(c, generator=g))
        bn.offset.copy_(torch.randn(c, generator=g) * 0.1)
        bn.mean.copy_(torch.randn(c, generator=g) * 0.1)
        bn.var.copy_(0.5 + torch.rand(c, generator=g))


# ---- the per-call formulations, as they stood -------------------------

def _bn_apply_plain(x, bn, eps=1e-5):
    a = bn.scale.to(x.dtype).float() * torch.rsqrt(bn.var.float() + eps)
    b = bn.offset.to(x.dtype).float() - bn.mean.float() * a
    return x * a.to(x.dtype)[:, None, None] + b.to(x.dtype)[:, None, None]


def _conv_plain(x, w, stride=1):
    return F.conv2d(x, w.to(x.dtype), stride=stride,
                    padding=(w.shape[2] - 1) // 2)


def _block_plain(x, blk):
    h = x
    n = len(blk.convs)
    for i, (w, bn) in enumerate(zip(blk.convs, blk.bns)):
        stride = blk.stride if i == (1 if n == 3 else 0) else 1
        h = _bn_apply_plain(_conv_plain(h, w, stride), bn)
        if i < n - 1:
            h = torch.relu(h)
    identity = x
    if blk.down is not None:
        identity = _bn_apply_plain(_conv_plain(x, blk.down, blk.stride),
                                   blk.down_bn)
    return torch.relu(h + identity)


def _cnn_plain(cnn, image, dt):
    x = image.to(dt).permute(0, 3, 1, 2)
    h = F.conv2d(x, cnn.conv1.to(dt), stride=2, padding=3)
    taps = [h]
    h = torch.relu(_bn_apply_plain(h, cnn.bn1))
    h = F.max_pool2d(h, 3, 2, padding=1)
    for layer in cnn.layers:
        for blk in layer:
            h = _block_plain(h, blk)
        taps.append(h)

    def remap(t, w, b):
        f = F.conv2d(t, w.to(dt)) + b.to(dt)[:, None, None]
        return f.permute(0, 2, 3, 1).contiguous()
    feats = [remap(t, w, b)
             for t, w, b in zip(taps, cnn.feature_w, cnn.feature_b)]
    by_layer = dict(zip(("conv1", "layer1", "layer2", "layer3", "layer4"),
                        taps))
    return feats, [remap(by_layer[l], w, b) for l, w, b in
                   zip(("layer3", "layer4"), cnn.output_w, cnn.output_b)]


def _batch_norm_eval_plain(x, mask, bn, eps=1e-5):
    mean, var = bn.mean, bn.var
    if x.dtype == torch.float32:
        y = (x - mean) * torch.reciprocal(torch.sqrt(var + eps))
        y = y * bn.scale + bn.offset
    else:
        scale = bn.scale.to(x.dtype).float()
        offset = bn.offset.to(x.dtype).float()
        a = scale * torch.reciprocal(torch.sqrt(var + eps))
        b = offset - mean * a
        y = x * a.to(x.dtype) + b.to(x.dtype)
    return torch.where(mask[:, None], y, torch.zeros((), dtype=y.dtype))


def _spline_conv_plain(x, nbr, nbr_mask, attr, conv, *, kernel_size,
                       x_dst=None, attr_range=None,
                       add_center_to_root=False):
    n, k = nbr.shape
    cin = x.shape[1]
    xd = x if x_dst is None else x_dst
    dt = x.dtype
    ranges = (((0, kernel_size - 1), (0, kernel_size - 1))
              if attr_range is None else tap_ranges(kernel_size, attr_range))
    (mx0, mx1), (my0, my1) = ranges
    m_sub = (mx1 - mx0 + 1) * (my1 - my0 + 1)
    cx, cy = spline_coeff_sep(attr, kernel_size, ranges, dtype=dt)
    cx = cx * nbr_mask[..., None]
    coeff = (cy[..., :, None] * cx[..., None, :]).reshape(n, k, m_sub)
    z = torch.einsum("nkm,nkc->nmc", coeff, x[nbr.long()])
    weight = conv.weight.to(dt)
    w_sub = weight[torch.as_tensor(sub_kernel_index(kernel_size, ranges))]
    out = z.reshape(n, m_sub * cin) @ w_sub.reshape(m_sub * cin, -1)
    root = conv.root.to(dt)
    if add_center_to_root:
        root = root + weight[center_index(kernel_size)]
    out = out + xd @ root
    if conv.bias is not None:
        out = out + conv.bias.to(dt)
    return out


def _eventad_plain(head, mc, features, coords, bbox_present, labels, *,
                   drop=0.0, generator=None, loss_items=slice(None)):
    """The per-item formulation: each item's fusion (its dropout mask
    drawn after the item's GRU masks) and cross entropy in the loop."""
    b, _, s1, _ = features.shape
    curr_feat = features[:, 1]
    dev = features.device
    slot_ids = torch.arange(s1, device=dev)
    valid = (bbox_present & (curr_feat.abs().sum(-1) > 0)
             & ((slot_ids >= 1) & (slot_ids <= mc.max_boxes))[None, :])
    h_event = torch.zeros((s1, mc.event_layers, mc.h_dim), device=dev)
    h_coord = torch.zeros((s1, mc.coord_layers, mc.coord_dim), device=dev)
    seen = torch.zeros((s1,), dtype=torch.bool, device=dev)
    gen = generator if drop > 0.0 else None
    p = head.fusion
    all_logits, losses = [], []
    for i in range(b):
        v = valid[i]
        h_in_e = torch.where(seen[:, None, None], h_event, 0.0)
        h_in_c = torch.where(seen[:, None, None], h_coord, 0.0)
        out_e, h_out_e = gru_step(
            head.gru_event, gru_input(head.gru_event, curr_feat[i]), h_in_e,
            dropout=drop, generator=gen)
        out_c, h_out_c = gru_step(head.gru_coord,
                                  gru_input(head.gru_coord, coords[i]),
                                  h_in_c)
        e = out_e @ p.event_proj_w + p.event_proj_b
        c = out_c @ p.coord_proj_w + p.coord_proj_b
        h = torch.relu(torch.cat([e, c], dim=-1) @ p.fuse1_w + p.fuse1_b)
        if gen is not None:
            keep = torch.rand(h.shape, generator=gen, device=dev) >= drop
            h = torch.where(keep, h / (1.0 - drop), 0.0)
        logits = h @ p.fuse2_w + p.fuse2_b
        ce = -F.log_softmax(logits, dim=-1).gather(
            1, labels[i][:, None].long())[:, 0]
        losses.append(torch.where(v, ce, 0.0).sum())
        att_e = spatial_attention(h_out_e, head.att_event_w, v)
        att_c = spatial_attention(h_out_c, head.att_coord_w, v)
        h_event = torch.where(v[:, None, None], att_e, h_event)
        h_coord = torch.where(v[:, None, None], att_c, h_coord)
        seen = seen | v
        all_logits.append(logits)
    return (torch.stack(all_logits), valid,
            torch.stack(losses[loss_items]).sum(),
            valid.sum().to(torch.int32))


# ---- fixtures ---------------------------------------------------------

@pytest.fixture(scope="module")
def cnn():
    g = torch.Generator().manual_seed(5)
    branch = CNNBranch("resnet50", [16, 8, 8, 8, 8], g,
                       output_channels=(8, 8))
    for bn in [branch.bn1] + [bn for layer in branch.layers for blk in layer
                              for bn in list(blk.bns) + [blk.down_bn]
                              if bn is not None]:
        _randomise_bn(bn, g)
    return branch.requires_grad_(False)


def _head_inputs(seed=3, b=6, mc=EventADConfig()):
    g = torch.Generator().manual_seed(seed)
    s1 = mc.max_boxes + 1
    feats = torch.randn(b, 2, s1, mc.x_dim, generator=g)
    feats[:, 1, 5] = 0.0                       # a slot without a feature
    return (feats, torch.rand(b, s1, 4, generator=g),
            torch.rand(b, s1, generator=g) > 0.3,
            (torch.rand(b, s1, generator=g) > 0.5).long())


# ---- bits of the prepared operands --------------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_cnn_branch_equals_the_per_call_fold(cnn, dtype):
    image = torch.rand(2, 48, 72, 3, generator=torch.Generator()
                       .manual_seed(7))
    want = _cnn_plain(cnn, image, DTYPES[dtype])
    for _ in range(2):                    # made, then read from the module
        got = cnn_branch_forward(cnn, image, dtype, outputs=True)
        for gs, ws in zip(got, want):
            assert [t.dtype for t in gs] == [DTYPES[dtype]] * len(ws)
            assert all(torch.equal(a, b) for a, b in zip(gs, ws))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_batch_norm_eval_equals_the_per_call_affine(dtype):
    g = torch.Generator().manual_seed(11)
    bn = BatchNorm(24)
    _randomise_bn(bn, g)
    x = torch.randn(300, 24, generator=g).to(DTYPES[dtype])
    mask = torch.rand(300, generator=g) > 0.2
    want = _batch_norm_eval_plain(x, mask, bn)
    for _ in range(2):
        assert torch.equal(batch_norm(x, mask, bn), want)


@pytest.mark.parametrize("center", [False, True])
def test_spline_conv_equals_the_per_call_gather(center):
    """f32, the level-0 layer's use (the self edge folded into the root,
    destination rows a subset, the static tap range) and the detection
    head's (a bias, every tap)."""
    g = torch.Generator().manual_seed(13 + center)
    ks, n, k = 5, 150, 9
    n_src = 400 if center else n
    conv = SplineConv(7, 12, ks, g, bias=not center)
    if conv.bias is not None:
        with torch.no_grad():
            conv.bias.uniform_(-1, 1, generator=g)
    x = torch.randn(n_src, 7, generator=g)
    nbr = torch.randint(0, n_src, (n, k), generator=g, dtype=torch.int32)
    nbr_mask = torch.rand(n, k, generator=g) > 0.25
    kw = dict(kernel_size=ks)
    if center:
        attr = 0.4 + 0.2 * torch.rand(n, k, 2, generator=g)
        kw.update(x_dst=x[-n:], attr_range=((0.4, 0.6), (0.4, 0.6)),
                  add_center_to_root=True)
    else:
        attr = torch.rand(n, k, 2, generator=g)
    want = _spline_conv_plain(x, nbr, nbr_mask, attr, conv, **kw)
    for _ in range(2):
        got = spline_conv(x, nbr, nbr_mask, attr, conv, **kw)
        assert torch.equal(got, want)


# ---- kept operands follow the weights -----------------------------------

@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kept_operands_follow_in_place_updates(dtype):
    """After an eval forward has kept its operands, a training-mode BN
    moves running statistics in place, ``ema_weights`` and a
    ``load_reference_state``-style ``copy_`` write the ResNet's and the
    level-0 conv's weights, and an optimizer-style ``add_`` moves a GRU
    weight: the next eval forward equals a fresh model's with the same
    state, bit for bit, and differs from the first."""
    cfg = Config(batch_size=2, width=48, height=36, scale=1,
                 event_buckets=(512,), graph_lookback=512, use_image=True,
                 compute_dtype=dtype)
    model, bc, mc = init_model(cfg, torch.Generator().manual_seed(1),
                               device="cpu")
    gsc = graph_static_config(cfg)
    batch = make_synthetic_batch(cfg, seed=2)

    def logits(m):
        with torch.no_grad():
            return model_forward(m, batch, bc, mc, gsc).logits

    first = logits(model)
    layer = model.dagr.backbone.layers[0]
    cnn = model.dagr.cnn
    g = torch.Generator().manual_seed(4)
    ema = ema_init(cnn.parameters())
    with torch.no_grad():
        batch_norm(torch.randn(64, layer.block1.bn.mean.shape[0],
                               generator=g), torch.ones(64, dtype=bool),
                   layer.block1.bn, training=True)
        cnn.bn1.var.mul_(1.5)
        for e in ema.params:
            e.mul_(0.75)
        layer.block1.conv.weight.copy_(layer.block1.conv.weight * 1.25)
        model.head.gru_event.layers[0].w_ih.add_(0.01)
    with torch.no_grad(), ema_weights(cnn.parameters(), ema):
        updated = logits(model)
        fresh, _, _ = init_model(cfg, torch.Generator().manual_seed(9),
                                 device="cpu")
        fresh.load_state_dict(model.state_dict())
        assert torch.equal(updated, logits(fresh))
    assert not torch.equal(updated, first)
    assert torch.equal(logits(model), logits(model))


def test_frozen_operands_keep_the_gradient_path():
    """Where autograd has to reach the weights (gradients on, weights that
    require them), the operands are made anew and recorded: the gradients
    of a ResNet weight, a BN scale and a spline conv weight equal the
    per-call formulation's."""
    g = torch.Generator().manual_seed(21)
    branch = CNNBranch("resnet18", [4] * 5, g)
    image = torch.rand(1, 32, 32, 3, generator=g)
    with torch.no_grad():                    # keeps operands first
        cnn_branch_forward(branch, image)
    cnn_branch_forward(branch, image)[4].sum().backward()
    got = branch.layers[0][0].convs[0].grad.clone()
    branch.zero_grad()
    _cnn_plain(branch, image, torch.float32)[0][4].sum().backward()
    assert torch.equal(got, branch.layers[0][0].convs[0].grad)

    bn, conv = BatchNorm(5), SplineConv(5, 3, 3, g)
    x = torch.randn(40, 5, generator=g)
    nbr = torch.randint(0, 40, (40, 4), generator=g, dtype=torch.int32)
    m = torch.ones(40, 4, dtype=bool)
    attr = torch.rand(40, 4, 2, generator=g)
    grads = []
    for f in (lambda: spline_conv(batch_norm(x, m[:, 0], bn), nbr, m, attr,
                                  conv, kernel_size=3),
              lambda: _spline_conv_plain(_batch_norm_eval_plain(
                  x, m[:, 0], bn), nbr, m, attr, conv, kernel_size=3)):
        with torch.no_grad():
            f()
        f().sum().backward()
        grads.append((bn.scale.grad.clone(), conv.weight.grad.clone()))
        bn.scale.grad = conv.weight.grad = None
    assert all(torch.equal(a, b) for a, b in zip(*grads))


# ---- the head's batched stateless work ----------------------------------

def test_batched_head_equals_the_per_item_loop_in_eval():
    mc = EventADConfig()
    head = EventADHead(mc, torch.Generator().manual_seed(2))
    inputs = _head_inputs()
    with torch.no_grad():
        got = eventad_forward(head, mc, *inputs)
        want = _eventad_plain(head, mc, *inputs)
    torch.testing.assert_close(got.logits, want[0], rtol=0, atol=1e-6)
    assert torch.equal(got.valid, want[1])
    torch.testing.assert_close(got.loss, want[2], rtol=1e-6, atol=1e-6)
    assert int(got.n_valid) == int(want[3])
    with torch.no_grad():
        part = eventad_forward(head, mc, *inputs, loss_items=slice(2, 4))
        want_part = _eventad_plain(head, mc, *inputs,
                                   loss_items=slice(2, 4))
    torch.testing.assert_close(part.loss, want_part[2], rtol=1e-6,
                               atol=1e-6)


def test_batched_head_keeps_the_dropout_draws_in_order():
    """Training under one seeded generator: the same logits, loss and
    gradients as the per-item loop with its interleaved draws, and the
    generator left in the same state."""
    mc = EventADConfig()
    head = EventADHead(mc, torch.Generator().manual_seed(2))
    inputs = _head_inputs(seed=8)
    gens = [torch.Generator().manual_seed(99) for _ in range(2)]
    out = eventad_forward(head, mc, *inputs, training=True,
                          generator=gens[0])
    out.loss.backward()
    got = [p.grad.clone() for p in head.parameters()]
    head.zero_grad()
    want = _eventad_plain(head, mc, *inputs, drop=mc.dropout,
                          generator=gens[1])
    want[2].backward()
    torch.testing.assert_close(out.logits, want[0], rtol=0, atol=1e-6)
    torch.testing.assert_close(out.loss, want[2], rtol=1e-6, atol=1e-6)
    for a, p in zip(got, head.parameters()):
        torch.testing.assert_close(a, p.grad, rtol=1e-5, atol=1e-6)
    assert torch.equal(gens[0].get_state(), gens[1].get_state())
    # dropout acted: the logits differ from the undropped forward's
    with torch.no_grad():
        assert not torch.allclose(out.logits,
                                  eventad_forward(head, mc, *inputs).logits)


# ---- operation counts -----------------------------------------------------

class _Count(TorchDispatchMode):
    """Operations dispatched, views left out."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += not func.is_view
        return func(*args, **(kwargs or {}))


def _count(fn):
    with torch.no_grad():
        fn()                                   # keeps the operands
        c = _Count()
        with c:
            fn()
    return c.n


def test_cnn_branch_dispatches_no_preparation(cnn):
    """bf16, batch 2: a conv, its BN's two operations and an activation
    for each of the 53 BNs, the remaps and the residual adds: under 5 a BN
    (882 with the per-call fold)."""
    image = torch.rand(2, 48, 72, 3)
    n_bn = 1 + sum(len(blk.bns) + (blk.down is not None)
                   for layer in cnn.layers for blk in layer)
    assert n_bn == 53
    assert _count(lambda: cnn_branch_forward(cnn, image, "bfloat16")) \
        <= 5 * n_bn


def test_head_dispatches_its_stateless_work_once():
    """B 6: 545 operations with the per-item fusion, cross entropy and
    input projections; at least 80 fewer run once a batch."""
    mc = EventADConfig()
    head = EventADHead(mc, torch.Generator().manual_seed(2))
    inputs = _head_inputs()
    assert _count(lambda: eventad_forward(head, mc, *inputs)) <= 545 - 80
