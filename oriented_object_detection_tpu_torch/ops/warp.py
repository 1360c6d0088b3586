"""Affine warp of uint8 images (cv2.warpAffine INTER_LINEAR, BORDER_CONSTANT
twin) in fixed point, the port of the JAX package's ``ops/warp.py``.

The destination->source coordinates are computed on the host in float64,
as OpenCV's double-precision path does, and kept as separable 1-D tables
(``adelta[out_w]``, ``X0[out_h]``, ...) quantized to 1/1024 px. The 2-D
combine, the 2x2 tap gather, the bilinear weights and the accumulation are
int32 on the device: the weights sum to exactly 2^20 and
``(acc + 2^19) >> 20`` rounds back to uint8. No float operation runs on the
device, so the tensor warps are bit-identical to the numpy mirror
``warp_affine_u8_np`` on every device.
"""

from __future__ import annotations

import numpy as np
import torch

FRAC_BITS = 10
FRAC_ONE = 1 << FRAC_BITS          # 1024
COEF_BITS = 2 * FRAC_BITS          # weight products scale, 2^20
ROUND_HALF = 1 << (COEF_BITS - 1)


def invert_affine(M: np.ndarray) -> np.ndarray:
    """cv2.invertAffineTransform in double precision. M: [2, 3]."""
    M = np.asarray(M, np.float64)
    D = M[0, 0] * M[1, 1] - M[0, 1] * M[1, 0]
    D = 1.0 / D if D != 0.0 else 0.0
    A00 = M[1, 1] * D
    A01 = -M[0, 1] * D
    A10 = -M[1, 0] * D
    A11 = M[0, 0] * D
    b0 = -A00 * M[0, 2] - A01 * M[1, 2]
    b1 = -A10 * M[0, 2] - A11 * M[1, 2]
    return np.array([[A00, A01, b0], [A10, A11, b1]], np.float64)


def affine_deltas(Minv: np.ndarray, out_h: int, out_w: int):
    """Separable fixed-point coordinate tables of a dst->src matrix, int32
    (adelta[out_w], bdelta[out_w], X0[out_h], Y0[out_h]): the source
    coordinate at dst (y, x) is X = X0[y] + adelta[x] (and Y alike), with
    integer part X >> FRAC_BITS and fraction X & (FRAC_ONE - 1)."""
    Minv = np.asarray(Minv, np.float64)
    x = np.arange(out_w, dtype=np.float64)
    y = np.arange(out_h, dtype=np.float64)
    adelta = np.rint(Minv[0, 0] * x * FRAC_ONE).astype(np.int32)
    bdelta = np.rint(Minv[1, 0] * x * FRAC_ONE).astype(np.int32)
    X0 = np.rint((Minv[0, 1] * y + Minv[0, 2]) * FRAC_ONE).astype(np.int32)
    Y0 = np.rint((Minv[1, 1] * y + Minv[1, 2]) * FRAC_ONE).astype(np.int32)
    return adelta, bdelta, X0, Y0


def warp_affine_u8_np(img: np.ndarray, Minv: np.ndarray,
                      out_h: int, out_w: int, border_value) -> np.ndarray:
    """Numpy mirror of the tensor warps: uint8 [H, W, C] in, uint8
    [out_h, out_w, C] out, BORDER_CONSTANT."""
    adelta, bdelta, X0, Y0 = affine_deltas(Minv, out_h, out_w)
    X = X0[:, None] + adelta[None, :]
    Y = Y0[:, None] + bdelta[None, :]
    imgi = img.astype(np.int32)
    border = np.asarray(border_value, np.int32).reshape(1, 1, -1)
    H, W = imgi.shape[:2]
    ix, iy = X >> FRAC_BITS, Y >> FRAC_BITS
    fx, fy = X & (FRAC_ONE - 1), Y & (FRAC_ONE - 1)

    def tap(iy_, ix_):
        ok = (iy_ >= 0) & (iy_ < H) & (ix_ >= 0) & (ix_ < W)
        v = imgi[np.clip(iy_, 0, H - 1), np.clip(ix_, 0, W - 1)]
        return np.where(ok[..., None], v, border)

    gx, gy = FRAC_ONE - fx, FRAC_ONE - fy
    acc = ((gy * gx)[..., None] * tap(iy, ix)
           + (gy * fx)[..., None] * tap(iy, ix + 1)
           + (fy * gx)[..., None] * tap(iy + 1, ix)
           + (fy * fx)[..., None] * tap(iy + 1, ix + 1))
    return np.clip((acc + ROUND_HALF) >> COEF_BITS, 0, 255).astype(np.uint8)


def _round_u8(acc: torch.Tensor) -> torch.Tensor:
    return torch.clamp((acc + ROUND_HALF) >> COEF_BITS, 0, 255).to(
        torch.uint8)


def warp_affine_u8(img: torch.Tensor, adelta, bdelta, X0, Y0,
                   border_value) -> torch.Tensor:
    """Warp of one image from ``affine_deltas`` tables (int32 tensors on the
    image's device): uint8 [H, W, C] -> uint8 [out_h, out_w, C], int32
    arithmetic throughout."""
    X = X0[:, None] + adelta[None, :]
    Y = Y0[:, None] + bdelta[None, :]
    ix, iy = X >> FRAC_BITS, Y >> FRAC_BITS
    fx, fy = X & (FRAC_ONE - 1), Y & (FRAC_ONE - 1)
    H, W = img.shape[:2]
    imgi = img.to(torch.int32)
    border = torch.as_tensor(border_value, dtype=torch.int32,
                             device=img.device).reshape(1, 1, -1)

    def tap(iy_, ix_):
        ok = (iy_ >= 0) & (iy_ < H) & (ix_ >= 0) & (ix_ < W)
        v = imgi[iy_.clamp(0, H - 1), ix_.clamp(0, W - 1)]
        return torch.where(ok[..., None], v, border)

    gx, gy = FRAC_ONE - fx, FRAC_ONE - fy
    acc = ((gy * gx)[..., None] * tap(iy, ix)
           + (gy * fx)[..., None] * tap(iy, ix + 1)
           + (fy * gx)[..., None] * tap(iy + 1, ix)
           + (fy * fx)[..., None] * tap(iy + 1, ix + 1))
    return _round_u8(acc)


def warp_axis_aligned_u8(img: torch.Tensor, adelta: torch.Tensor,
                         X0: torch.Tensor, Y0: torch.Tensor,
                         border_value) -> torch.Tensor:
    """The scale + translate case (bdelta == 0, X0 constant per image) of
    ``warp_affine_u8``, batched: img uint8 [B, H, W, C], adelta [B, out_w],
    X0 and Y0 [B, out_h] -> uint8 [B, out_h, out_w, C].

    The source coordinate factorizes as ix(x), iy(y), so the bilinear warp
    is a gather along W and one along H. Bit-identical to the general warp:
    the border is constant, so a tap outside in y contributes
    FRAC_ONE * border whatever the x weights; intermediates stay below
    2^30."""
    B, H, W = img.shape[:3]
    X = X0[:, :1] + adelta                 # [B, out_w]
    ix, fx = X >> FRAC_BITS, X & (FRAC_ONE - 1)
    iy, fy = Y0 >> FRAC_BITS, Y0 & (FRAC_ONE - 1)
    imgi = img.to(torch.int32)
    border = torch.as_tensor(border_value, dtype=torch.int32,
                             device=img.device).reshape(1, 1, 1, -1)
    gx, gy = FRAC_ONE - fx, FRAC_ONE - fy
    b = torch.arange(B, device=img.device)[:, None]

    def tapx(ix_):
        ok = (ix_ >= 0) & (ix_ < W)
        v = imgi[b, :, ix_.clamp(0, W - 1)]          # [B, out_w, H, C]
        v = v.permute(0, 2, 1, 3)                     # [B, H, out_w, C]
        return torch.where(ok[:, None, :, None], v, border)

    px = gx[:, None, :, None] * tapx(ix) + fx[:, None, :, None] * tapx(ix + 1)

    def tapy(iy_):
        ok = (iy_ >= 0) & (iy_ < H)
        v = px[b, iy_.clamp(0, H - 1)]                # [B, out_h, out_w, C]
        return torch.where(ok[:, :, None, None], v, border * FRAC_ONE)

    acc = gy[:, :, None, None] * tapy(iy) + fy[:, :, None, None] * tapy(iy + 1)
    return _round_u8(acc)
