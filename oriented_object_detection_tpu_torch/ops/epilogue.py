"""The folded ConvBN's epilogue: its bias added to the convolution's output
and SiLU applied (or the bias alone, for a ConvBN without activation),
then optionally a per-channel scale and a residual, stored in place or to
one or two destinations.

``bias_silu_nhwc`` launches the CUDA kernel of ``csrc/epilogue.cu`` on a
CUDA tensor, which must be channels-last (the detector's forward keeps its
activations so: ``models/layers.py``), and runs ``bias_silu_nhwc_plain``,
PyTorch's broadcast add, ``F.silu``, product, sum and ``copy_``, on a CPU
tensor. The kernel is bit-equal to the plain version on the card. It
replaces no TPU kernel: it takes the place of the broadcast bias pass, the
separate SiLU pass and, where a block builds its concatenation in place,
the residual add and the concatenation's copy of this part.

A destination is a pair ``(t, first)``: ``t`` [N, n, H, W] receives
channels ``[first, first + n)`` of the result. On the card its channels
are innermost and its pixels evenly spaced: a channel slice of a
channels-last tensor, such as a block's concatenation buffer, or a packed
channels-last tensor.

``LAUNCHES`` counts kernel launches: one per fused ConvBN per forward.
``STORES`` counts, on either device, the epilogues that store into a
channel slice of a wider tensor (``concat_parts``: a part of a
concatenation) and those that add a residual (``residual_folds``).
"""

from __future__ import annotations

import ctypes
import functools
import os

import torch
import torch.nn.functional as F

from ..utils.build import (NVCC_FLAGS, build_shared_library, launch, nvcc,
                           stream)

KERNEL_SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "epilogue.cu")

LAUNCHES = {"bias_silu_nhwc": 0}
STORES = {"concat_parts": 0, "residual_folds": 0}


@functools.cache
def kernel_library() -> ctypes.CDLL:
    """Build ``csrc/epilogue.cu`` with nvcc for sm_90a (first call only)
    and bind its launcher."""
    lib = build_shared_library("epilogue", [KERNEL_SOURCE],
                               [nvcc()] + NVCC_FLAGS, timeout=300)
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.bias_silu_nhwc_launch.restype = ci
    lib.bias_silu_nhwc_launch.argtypes = [vp, vp, vp, vp, cl,
                                          vp, cl, ci, ci, vp, cl, ci, ci,
                                          cl, ci, ci, ci, vp]
    return lib


def bias_silu_nhwc_plain(y: torch.Tensor, bias: torch.Tensor, act: bool,
                         outs=(), residual: torch.Tensor | None = None,
                         scale: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: ``y + bias`` in ``y``'s dtype (in place), SiLU when
    ``act``, then ``scale * y`` and ``residual + y`` when given, each
    rounded to ``y``'s dtype; stored into each destination of ``outs`` by
    ``copy_``. y, residual: [N, C, H, W] in any layout; bias, scale: [C].
    Returns the first destination's tensor, or the result where ``outs``
    is empty."""
    y = y.add_(bias.to(y.dtype)[:, None, None])
    if act:
        y = F.silu(y)
    if scale is not None:
        y = scale.to(y.dtype)[:, None, None] * y
    if residual is not None:
        y = residual + y
    for t, first in outs:
        t.copy_(y[:, first:first + t.shape[1]])
    return outs[0][0] if outs else y


def pixel_stride(t: torch.Tensor, shape) -> int:
    """Elements between neighbouring pixels of ``t``, an [N, C, H, W]
    tensor of ``shape`` whose channels are innermost and whose pixels are
    evenly spaced (channels-last, or a channel slice of it); raises
    otherwise."""
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"bias_silu_nhwc: shape {tuple(t.shape)}, not "
                         f"{tuple(shape)}")
    _, c, h, w = shape
    p = t.stride(3)
    if p < c or any(n > 1 and s != want for n, s, want in zip(
            t.shape, t.stride(), (h * w * p, 1, w * p, p))):
        raise ValueError(f"bias_silu_nhwc wants channels innermost and "
                         f"pixels evenly spaced, got {tuple(t.shape)} "
                         f"strides {t.stride()}")
    return p


def bias_silu_nhwc(y: torch.Tensor, bias: torch.Tensor, act: bool,
                   outs=(), residual: torch.Tensor | None = None,
                   scale: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel on a CUDA tensor, its plain version on a CPU tensor.
    y: bf16 or float32 [N, C, H, W], packed channels-last on the card;
    bias, scale: [C] (on the card a scale only with a residual); residual:
    y's shape and dtype. The result goes to each destination of ``outs``
    (at most two on the card), or back into ``y`` where ``outs`` is empty.
    Returns the first destination's tensor, or the result."""
    if outs and any(t.stride(0) > t[0].numel() for t, _ in outs):
        STORES["concat_parts"] += 1
    if residual is not None:
        STORES["residual_folds"] += 1
    if y.device.type == "cpu":
        return bias_silu_nhwc_plain(y, bias, act, outs, residual, scale)
    if y.device.type != "cuda":
        raise ValueError(f"bias_silu_nhwc: unsupported device {y.device}")
    if (y.dim() != 4 or y.dtype not in (torch.bfloat16, torch.float32)
            or not y.is_contiguous(memory_format=torch.channels_last)):
        raise ValueError(
            f"bias_silu_nhwc wants a channels-last bf16/float32 [N, C, H, W], "
            f"got {y.dtype} {tuple(y.shape)} strides {y.stride()}")
    if y.requires_grad:
        raise ValueError("bias_silu_nhwc has no backward: call it under "
                         "torch.no_grad or torch.inference_mode")
    if scale is not None and residual is None:
        raise ValueError("bias_silu_nhwc scales only with a residual")
    N, C, H, W = y.shape
    vectors = [bias.to(y.dtype)] + ([] if scale is None
                                    else [scale.to(y.dtype)])
    if any(v.shape != (C,) or not v.is_contiguous() or v.device != y.device
           for v in vectors):
        raise ValueError(f"bias_silu_nhwc wants a contiguous bias (and "
                         f"scale) [C] on {y.device}")
    tensors = ([] if residual is None else [residual]) + [t for t, _ in outs]
    if any(t.dtype != y.dtype or t.device != y.device for t in tensors):
        raise ValueError(f"bias_silu_nhwc wants the residual and the "
                         f"destinations in {y.dtype} on {y.device}")
    res = (None, 0) if residual is None else (
        residual.data_ptr(), pixel_stride(residual, y.shape))
    dests = [(t.data_ptr(), pixel_stride(t, (N, t.shape[1], H, W)), first,
              t.shape[1]) for t, first in outs] or [(y.data_ptr(), C, 0, C)]
    if len(dests) > 2 or any(f < 0 or f + n > C for _, _, f, n in dests):
        raise ValueError(f"bias_silu_nhwc stores one or two runs of its "
                         f"{C} channels, got {[d[2:] for d in dests]}")
    dests += [(None, 0, 0, 0)] * (2 - len(dests))
    launch("bias_silu_nhwc", kernel_library().bias_silu_nhwc_launch,
           y.data_ptr(), vectors[0].data_ptr(),
           vectors[1].data_ptr() if scale is not None else None, *res,
           *dests[0], *dests[1], y.numel(), C, int(act),
           int(y.dtype == torch.bfloat16), stream(y))
    LAUNCHES["bias_silu_nhwc"] += 1
    return outs[0][0] if outs else y
