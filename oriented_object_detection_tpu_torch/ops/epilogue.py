"""The folded ConvBN's epilogue: its bias added to the convolution's output
and SiLU applied (or the bias alone, for a ConvBN without activation), in
place.

``bias_silu_nhwc`` launches the CUDA kernel of ``csrc/epilogue.cu`` on a
CUDA tensor, which must be channels-last (the detector's forward keeps its
activations so: ``models/layers.py``), and runs ``bias_silu_nhwc_plain``,
PyTorch's broadcast add and ``F.silu``, on a CPU tensor. The kernel is
bit-equal to the plain version on the card. It replaces no TPU kernel: it
takes the place of the broadcast bias pass and the separate SiLU pass.
``LAUNCHES`` counts kernel launches: one per fused ConvBN per forward.
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


@functools.cache
def kernel_library() -> ctypes.CDLL:
    """Build ``csrc/epilogue.cu`` with nvcc for sm_90a (first call only)
    and bind its launcher."""
    lib = build_shared_library("epilogue", [KERNEL_SOURCE],
                               [nvcc()] + NVCC_FLAGS, timeout=300)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.bias_silu_nhwc_launch.restype = ci
    lib.bias_silu_nhwc_launch.argtypes = [vp, vp, ctypes.c_longlong, ci, ci,
                                          ci, vp]
    return lib


def bias_silu_nhwc_plain(y: torch.Tensor, bias: torch.Tensor,
                         act: bool) -> torch.Tensor:
    """Plain version: ``y + bias`` in ``y``'s dtype (in place), then SiLU
    when ``act``. y: [N, C, H, W] in any layout; bias: [C]."""
    y = y.add_(bias.to(y.dtype)[:, None, None])
    return F.silu(y) if act else y


def bias_silu_nhwc(y: torch.Tensor, bias: torch.Tensor,
                   act: bool) -> torch.Tensor:
    """The kernel on a CUDA tensor, in place, its plain version on a CPU
    tensor. y: bf16 or float32 [N, C, H, W], channels-last on the card;
    bias: [C]. Returns the result."""
    if y.device.type == "cpu":
        return bias_silu_nhwc_plain(y, bias, act)
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
    bias = bias.to(y.dtype)
    if (bias.shape != (y.shape[1],) or not bias.is_contiguous()
            or bias.device != y.device):
        raise ValueError(f"bias_silu_nhwc wants a contiguous bias [C] on "
                         f"{y.device}")
    launch("bias_silu_nhwc", kernel_library().bias_silu_nhwc_launch,
           y.data_ptr(), bias.data_ptr(), y.numel(), y.shape[1], int(act),
           int(y.dtype == torch.bfloat16), stream(y))
    LAUNCHES["bias_silu_nhwc"] += 1
    return y
