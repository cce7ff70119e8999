"""The detection read-out's post-process as one hand-written kernel (K9).

:func:`postprocess_cuda` computes ``models/yolox_head.postprocess_plain``'s
function (the xyxy boxes, class max and score of every anchor, then
class-offset NMS with a fixed output size) by ``csrc/nms.cu`` in one launch
on the current stream, one block an image, where the plain version issues
about 585 operations at 175 anchors (its greedy pass a Python loop of one
step an anchor).  The outputs equal the plain version's on the card bit for
bit.  ``models/yolox_head.postprocess`` dispatches: a CUDA tensor to K9, a
CPU one to the plain version.
"""
from __future__ import annotations

import ctypes

import torch

from .kernels import launch, ptr

# as csrc/nms.cu: the keep set is one 32-bit word a lane of one warp, and an
# image's bitmask (A x A bits) stays in shared memory
MAX_ANCHORS = 1024
MAX_CLASSES = 32


def postprocess_layout(outputs: torch.Tensor, num_classes: int, *,
                       conf_threshold: float, max_out: int) -> tuple:
    """K9's argument check, the device aside: raises ``ValueError`` on what
    the kernel does not take.  ``outputs [B, A, D]`` contiguous f32 with
    ``1 <= A <= MAX_ANCHORS`` and ``D >= 5 + num_classes``, ``1 <=
    num_classes <= MAX_CLASSES``, ``max_out >= 1``, a ``conf_threshold``
    above 0 (no surviving score is then a signed zero, which PyTorch's
    stable sorts order differently by length) and no gradient to record
    (the kernel has none).  Returns ``(b, a, m)``, ``m = min(a,
    max_out)``."""
    if outputs.dtype != torch.float32 or outputs.dim() != 3:
        raise ValueError(f"outputs: expected a 3-D float32 tensor, got "
                         f"{outputs.dtype} {tuple(outputs.shape)}")
    b, a, d = outputs.shape
    if not 1 <= num_classes <= MAX_CLASSES:
        raise ValueError(f"num_classes: 1 to {MAX_CLASSES}, got "
                         f"{num_classes}")
    if d < 5 + num_classes:
        raise ValueError(f"outputs: {d} columns, fewer than 5 + "
                         f"{num_classes}")
    if not 1 <= a <= MAX_ANCHORS:
        raise ValueError(f"outputs: 1 to {MAX_ANCHORS} anchors, got {a}")
    if b < 1 or max_out < 1:
        raise ValueError(f"outputs: {b} images, max_out {max_out}")
    if not conf_threshold > 0:
        raise ValueError(f"conf_threshold: above 0, got {conf_threshold}")
    if not outputs.is_contiguous():
        raise ValueError("outputs: expected a contiguous tensor")
    if torch.is_grad_enabled() and outputs.requires_grad:
        raise ValueError("outputs: K9 records no gradient")
    return b, a, min(a, max_out)


def postprocess_cuda(outputs: torch.Tensor, num_classes: int, *,
                     conf_threshold: float = 0.001,
                     nms_threshold: float = 0.65, width: int = 640,
                     height: int = 640, max_out: int = 64) -> dict:
    """K9: ``postprocess_plain``'s outputs (``boxes [B, M, 4]`` xyxy f32,
    ``scores [B, M]`` f32, ``labels [B, M]`` int64, ``mask [B, M]`` bool,
    ``M = min(A, max_out)``) by ``csrc/nms.cu``, one launch, nothing
    synchronised.  Takes a CUDA tensor in the layout
    :func:`postprocess_layout` states; raises ``ValueError`` on anything
    else."""
    b, a, m = postprocess_layout(outputs, num_classes,
                                 conf_threshold=conf_threshold,
                                 max_out=max_out)
    if not outputs.is_cuda:
        raise ValueError(f"outputs: expected a CUDA tensor, got "
                         f"{outputs.device}")
    dev = outputs.device
    out = {"boxes": torch.empty((b, m, 4), dtype=torch.float32, device=dev),
           "scores": torch.empty((b, m), dtype=torch.float32, device=dev),
           "labels": torch.empty((b, m), dtype=torch.int64, device=dev),
           "mask": torch.empty((b, m), dtype=torch.bool, device=dev)}
    dims = (ctypes.c_int * 5)(b, a, outputs.shape[2], num_classes, m)
    # as PyTorch rounds the Python scalars for an f32 tensor
    thr = (ctypes.c_float * 3)(conf_threshold, nms_threshold,
                               max(width, height) + 1)
    launch("eventad_postprocess", ptr(outputs), dims, thr,
           ptr(out["boxes"]), ptr(out["scores"]), ptr(out["labels"]),
           ptr(out["mask"]))
    postprocess_cuda.launches += 1
    return out


postprocess_cuda.launches = 0
