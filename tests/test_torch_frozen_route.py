"""The one route of a frozen forward (``models/backbone.frozen_route``)
against the predicates it replaced, copied here as they stood: the
layer's gate of ``apply_layer``, ``backbone_forward``'s ``fused_pooled``
and image-rows choice, and the GNN head's ``head_takes_shift``.  Over
dtype, device (a CUDA device as the route sees it: only its type is read),
training, aggregation, the three flavour flags and every activation a
configuration can name; the kernels' activation table also holds None,
which no configuration sets and on which the old predicates disagreed
among themselves.  The pooled levels' image lookup, which no predicate
chose before (it was always ``sample_image_features``), takes K7 exactly
in a bf16 eval forward on the card, whatever the flags and aggregation."""
import itertools

import pytest
import torch

from eventad_tpu_torch.config import Config
from eventad_tpu_torch.models.backbone import (frozen_route,
                                                make_backbone_config)
from eventad_tpu_torch.ops.spline_basis import ACT_CODES

import _torch_threads  # noqa: F401  (one intra-op thread)

BC = make_backbone_config(Config())
FLAGS = list(itertools.product((False, True), repeat=3))


def _layer_gate(dt, is_cuda, training, bc, pooled):
    fused_act = bc.activation in ("relu", "elu", "hardtanh", "silu")
    use_whole_layer = fused_act and (bc.fused_shift if pooled
                                     else bc.fused_two_block)
    use_fused = (dt == torch.bfloat16 and bc.aggr == "sum" and not training
                 and (is_cuda or not use_whole_layer))
    if not use_fused:
        return "plain"
    return ("K3" if pooled else "K2") if use_whole_layer else "K5"


def _fused_pooled(dt, is_cuda, training, bc):
    return (dt == torch.bfloat16 and bc.aggr == "sum" and not training
            and (is_cuda or not bc.fused_shift))


def _image_rows(dt, training, bc):
    if bc.bilinear_kernel:
        return "K7"
    return "K4" if dt == torch.bfloat16 and not training else "plain"


def _pooled_image(dt, is_cuda, training):
    return ("K7" if dt == torch.bfloat16 and is_cuda and not training
            else "plain")


def _head_takes_shift(dt, is_cuda, training, bc):
    return (dt == torch.bfloat16 and is_cuda and bc.aggr == "sum"
            and not training and bc.fused_shift
            and bc.activation in ACT_CODES)


@pytest.mark.parametrize("activation",
                         [a for a in ACT_CODES if a is not None])
@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32])
def test_route_equals_the_predicates_it_replaced(dt, device, training,
                                                 activation):
    is_cuda = device == "cuda"
    for (two_block, shift, bilinear), aggr in itertools.product(
            FLAGS, ("sum", "mean")):
        bc = BC._replace(aggr=aggr, activation=activation,
                         fused_two_block=two_block, fused_shift=shift,
                         bilinear_kernel=bilinear)
        route = frozen_route(bc, dt, torch.device(device), training)
        where = (bc.aggr, two_block, shift, bilinear)
        assert route.level0 == _layer_gate(dt, is_cuda, training, bc,
                                           False), where
        assert route.pooled == _layer_gate(dt, is_cuda, training, bc,
                                           True), where
        assert (route.pooled != "plain") == _fused_pooled(
            dt, is_cuda, training, bc), where
        assert route.image_rows == _image_rows(dt, training, bc), where
        assert route.pooled_image == _pooled_image(dt, is_cuda,
                                                   training), where
        assert (route.pooled == "K3") == _head_takes_shift(
            dt, is_cuda, training, bc), where
