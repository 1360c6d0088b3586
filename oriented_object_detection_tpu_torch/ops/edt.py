"""Exact Euclidean distance transform (L2 EDT), batched.

Two separable passes, each a CUDA kernel (``csrc/edt.cu``) beside a plain
PyTorch version of the same function:

  pass 1 (columns): d0[i, j] = min(|i - k| : mask[k, j]), capped at 1e9
  pass 2 (rows):    D[i, j] = sqrt(min(D2[i, j], 1e18)),
                    D2[i, j] = min_k min(d0[i, k], 1e9)^2 + (j - k)^2

so ``edt_l2`` is the two passes and nothing else (two kernel launches on
the card), and equals ``scipy.ndimage.distance_transform_edt(~mask)``. A
wrapper runs its plain version only for a tensor on the CPU; for a CUDA
tensor it launches the kernel or raises. ``LAUNCHES`` counts kernel
launches per wrapper.
"""

from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from ..utils.build import (NVCC_FLAGS, build_shared_library, launch, nvcc,
                           stream)

INF = 1e9
KERNEL_SOURCE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc", "edt.cu")
# a block's shared-memory limit on Hopper: pass 2 stages its rows there
MAX_SMEM_BYTES = 232448

LAUNCHES = {"edt_pass1_columns": 0, "edt_pass2_rows": 0}


@functools.cache
def kernel_library() -> ctypes.CDLL:
    """Build ``csrc/edt.cu`` with nvcc for sm_90a (first call only) and
    bind its launchers."""
    lib = build_shared_library("edt", [KERNEL_SOURCE],
                               [nvcc()] + NVCC_FLAGS, timeout=300)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.edt_pass1_columns_launch.restype = ci
    lib.edt_pass1_columns_launch.argtypes = [vp, vp, ci, ci, ci, vp]
    lib.edt_pass2_rows_launch.restype = ci
    lib.edt_pass2_rows_launch.argtypes = [vp, vp, ci, ci, vp]
    lib.edt_pass2_rows_smem_bytes.restype = ctypes.c_size_t
    lib.edt_pass2_rows_smem_bytes.argtypes = [ci]
    return lib


# ---------------------------------------------------------------------------
# Pass 1: per-column distance to the nearest edge pixel
# ---------------------------------------------------------------------------

def edt_pass1_columns_plain(mask: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: log-step doubling d[i] = min(d[i], d[i+-s] + s)
    for s = 1, 2, 4, ... (exact after ceil(log2 H) rounds), capped at 1e9.
    mask: [..., H, W] bool/uint8 (nonzero = edge) -> float32."""
    d = torch.where(mask != 0, 0.0, INF).to(torch.float32)
    H = d.shape[-2]
    s = 1
    while s < H:
        pad = torch.full((*d.shape[:-2], s, d.shape[-1]), INF,
                         dtype=torch.float32, device=d.device)
        up = torch.cat([d[..., s:, :], pad], dim=-2) + float(s)
        down = torch.cat([pad, d[..., :-s, :]], dim=-2) + float(s)
        d = torch.minimum(d, torch.minimum(up, down))
        s *= 2
    return torch.clamp_max(d, INF)


def edt_pass1_columns(mask: torch.Tensor) -> torch.Tensor:
    """K1 on a CUDA tensor, its plain version on a CPU tensor.
    mask: [B, H, W] bool or uint8 (nonzero = edge) -> float32 [B, H, W]."""
    if mask.device.type == "cpu":
        return edt_pass1_columns_plain(mask)
    if mask.device.type != "cuda":
        raise ValueError(f"edt_pass1_columns: unsupported device "
                         f"{mask.device}")
    if mask.dim() != 3 or mask.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"edt_pass1_columns wants bool/uint8 [B, H, W], "
                         f"got {mask.dtype} {tuple(mask.shape)}")
    B, H, W = mask.shape
    mask = mask.contiguous()
    out = torch.empty(mask.shape, dtype=torch.float32, device=mask.device)
    launch("edt_pass1_columns", kernel_library().edt_pass1_columns_launch,
           mask.data_ptr(), out.data_ptr(), B, H, W, stream(mask))
    LAUNCHES["edt_pass1_columns"] += 1
    return out


# ---------------------------------------------------------------------------
# Pass 2: per-row min-plus against the parabola family
# ---------------------------------------------------------------------------

def edt_pass2_rows_plain(d0: torch.Tensor, chunk: int = 32) -> torch.Tensor:
    """Plain version of K2: chunked brute force over output columns, then
    the capped, correctly rounded sqrt.
    d0: [N, W] float32 column distances -> distances [N, W]."""
    f = torch.clamp_max(d0, INF)
    f = f * f
    W = f.shape[-1]
    k = torch.arange(W, dtype=torch.float32, device=f.device)
    out = torch.empty_like(f)
    for c0 in range(0, W, chunk):
        j = torch.arange(c0, min(c0 + chunk, W), dtype=torch.float32,
                         device=f.device)
        para = j[:, None] - k[None, :]
        para = para * para                                  # [chunk, W]
        out[:, c0:c0 + len(j)] = (f[:, None, :] + para).amin(dim=-1)
    return sqrt_rn(torch.clamp_max(out, INF * INF))


def edt_pass2_rows(d0: torch.Tensor) -> torch.Tensor:
    """K2 on a CUDA tensor, its plain version on a CPU tensor.
    d0: float32 [N, W] column distances -> float32 [N, W] distances."""
    if d0.device.type == "cpu":
        return edt_pass2_rows_plain(d0)
    if d0.device.type != "cuda":
        raise ValueError(f"edt_pass2_rows: unsupported device {d0.device}")
    if d0.dim() != 2 or d0.dtype != torch.float32:
        raise ValueError(f"edt_pass2_rows wants float32 [N, W], got "
                         f"{d0.dtype} {tuple(d0.shape)}")
    N, W = d0.shape
    smem = kernel_library().edt_pass2_rows_smem_bytes(W)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(f"edt_pass2_rows: a row of {W} floats needs "
                         f"{smem} bytes of shared memory, over the "
                         f"{MAX_SMEM_BYTES} a block can have")
    d0 = d0.contiguous()
    out = torch.empty_like(d0)
    launch("edt_pass2_rows", kernel_library().edt_pass2_rows_launch,
           d0.data_ptr(), out.data_ptr(), N, W, stream(d0))
    LAUNCHES["edt_pass2_rows"] += 1
    return out


# ---------------------------------------------------------------------------
# Full transform
# ---------------------------------------------------------------------------

def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 sqrt rounded to nearest, as IEEE and the reference round it.
    PyTorch's CPU sqrt kernels are not always correctly rounded (in
    float32 they miss by one ulp; in float64 rounded to float32 they did
    now and then on a first call), so on the CPU this takes numpy's, which
    is the hardware's. On CUDA, float32 ``torch.sqrt`` is correctly
    rounded: chip_smoke.py checks it against a float64 sqrt rounded once
    to float32 over every non-negative finite float32."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.detach().numpy()))
    return torch.sqrt(x)


def _edt_from_passes(mask: torch.Tensor, pass1, pass2) -> torch.Tensor:
    *lead, H, W = mask.shape
    d0 = pass1(mask.reshape(-1, H, W))
    return pass2(d0.reshape(-1, W)).reshape(*lead, H, W)


def edt_l2(mask: torch.Tensor) -> torch.Tensor:
    """Exact Euclidean distance to the nearest nonzero pixel of ``mask``
    ([..., H, W] bool), through the kernels on a CUDA tensor."""
    return _edt_from_passes(mask, edt_pass1_columns, edt_pass2_rows)


def edt_l2_plain(mask: torch.Tensor) -> torch.Tensor:
    """``edt_l2`` through the plain versions on any device (the reference
    the kernels are held to)."""
    return _edt_from_passes(mask, edt_pass1_columns_plain,
                            edt_pass2_rows_plain)
