"""DT-Edge 4th-channel synthesis, batched on the device.

Port of the JAX package's ``ops/dtedge.py`` (`Detect_OBB.py:87-133`):
multi-scale Scharr gradient magnitude -> percentile binarize -> cross
morphological open -> exact L2 distance transform of the non-edge mask
(``edt.py``, the CUDA kernels on the card) -> 1-99 percentile normalize ->
soft map exp(-d/tau) blended 0.7*soft + 0.3*minmax(acc) -> uint8.

Every elementwise step repeats the reference's operations in the same order,
in float32: gray and each Gaussian blur round to uint8 values before the next
stage, the separable convolution sums shifted slices left to right, and the
percentiles are exact order statistics with the reference's interpolation.
A different order would move a value by one ulp and flip a round at .5.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import DTEdgeConfig
from .edt import edt_l2, sqrt_rn


def bgr_to_gray_u8(bgr: torch.Tensor) -> torch.Tensor:
    """cv2 BGR->GRAY: Y = 0.299 R + 0.587 G + 0.114 B, rounded (float32)."""
    b, g, r = (bgr[..., i].to(torch.float32) for i in range(3))
    return torch.round(0.299 * r + 0.587 * g + 0.114 * b)


def _gaussian_kernel_1d(sigma: float) -> np.ndarray:
    """cv2 getGaussianKernel for uint8 inputs: ksize = round(6*sigma+1)|1."""
    ksize = int(round(sigma * 3 * 2 + 1)) | 1
    half = ksize // 2
    x = np.arange(-half, half + 1, dtype=np.float64)
    g = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _sep_conv2d(img: torch.Tensor, kx: np.ndarray, ky: np.ndarray
                ) -> torch.Tensor:
    """Separable conv over [B, H, W] with REFLECT_101 borders, summed over
    shifted slices in the reference's order."""
    khx, khy = len(kx) // 2, len(ky) // 2
    H, W = img.shape[-2:]
    x = F.pad(img, (khx, khx, khy, khy), mode="reflect")
    x = sum(float(kx[i]) * x[..., :, i:i + W] for i in range(len(kx)))
    return sum(float(ky[i]) * x[..., i:i + H, :] for i in range(len(ky)))


def gaussian_blur_u8(gray: torch.Tensor, sigma: float) -> torch.Tensor:
    """GaussianBlur of uint8-valued gray, rounded back to uint8 values."""
    k = _gaussian_kernel_1d(sigma)
    return torch.clamp(torch.round(_sep_conv2d(gray, k, k)), 0, 255)


def scharr_magnitude(gray: torch.Tensor) -> torch.Tensor:
    """sqrt(Scharr_x^2 + Scharr_y^2), REFLECT_101 borders, float32."""
    deriv = np.array([-1.0, 0.0, 1.0], np.float32)
    smooth = np.array([3.0, 10.0, 3.0], np.float32)
    gx = _sep_conv2d(gray, deriv, smooth)
    gy = _sep_conv2d(gray, smooth, deriv)
    return sqrt_rn(gx * gx + gy * gy)


def multi_scale_scharr(gray: torch.Tensor, sigmas) -> torch.Tensor:
    """Max of Scharr magnitudes over Gaussian pre-blur scales."""
    acc = None
    for s in sigmas:
        mag = scharr_magnitude(gaussian_blur_u8(gray, s) if s > 0 else gray)
        acc = mag if acc is None else torch.maximum(acc, mag)
    return acc


def percentile_hw(x: torch.Tensor, qs) -> torch.Tensor:
    """np.percentile (linear interpolation) per image over the trailing
    H, W dims: [B, H, W] -> [B, len(qs)]. Exact order statistics from a
    sort, then the reference's interpolation arithmetic in float32."""
    flat = x.reshape(x.shape[0], -1)
    n = flat.shape[-1]
    srt = torch.sort(flat, dim=-1).values
    out = []
    for q in qs:
        h = (n - 1) * (float(q) / 100.0)
        v_fl = srt[:, int(np.floor(h))]
        v_ce = srt[:, int(np.ceil(h))]
        out.append(v_fl + (v_ce - v_fl) * float(np.float32(h - np.floor(h))))
    # +0.0 turns a -0.0 order statistic into +0.0, as the bit search does
    return torch.stack(out, dim=-1) + 0.0


def _shift2d(x: torch.Tensor, dy: int, dx: int, fill: bool) -> torch.Tensor:
    out = torch.full_like(x, fill)
    H, W = x.shape[-2:]
    ys = slice(max(dy, 0), H + min(dy, 0))
    yd = slice(max(-dy, 0), H + min(-dy, 0))
    xs = slice(max(dx, 0), W + min(dx, 0))
    xd = slice(max(-dx, 0), W + min(-dx, 0))
    out[..., yd, xd] = x[..., ys, xs]
    return out


_CROSS = ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1))  # 3x3 ELLIPSE support


def morph_open_cross(mask: torch.Tensor, iterations: int = 1
                     ) -> torch.Tensor:
    """Binary opening with cv2's 3x3 MORPH_ELLIPSE (a cross). cv2 border
    semantics: erosion sees outside as set, dilation as unset."""
    m = mask
    for _ in range(iterations):
        acc = torch.ones_like(m)
        for dy, dx in _CROSS:
            acc = acc & _shift2d(m, dy, dx, True)
        m = acc
    for _ in range(iterations):
        acc = torch.zeros_like(m)
        for dy, dx in _CROSS:
            acc = acc | _shift2d(m, dy, dx, False)
        m = acc
    return m


def edge_mask(bgr: torch.Tensor, cfg: DTEdgeConfig = DTEdgeConfig()
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Edge mask of a batch of BGR uint8 images [B, H, W, 3]: gray ->
    multi-scale Scharr magnitude -> pixels at or above its ``p_hi``
    percentile -> cross morphological open. Returns the bool mask
    [B, H, W] (what the EDT measures distances to) and the magnitude."""
    gray = bgr_to_gray_u8(bgr)
    acc = multi_scale_scharr(gray, cfg.sigmas)
    edges = acc >= percentile_hw(acc, (cfg.p_hi,))[:, :, None]
    if cfg.morph_open > 0:
        edges = morph_open_cross(edges, cfg.morph_open)
    return edges, acc


def dt_edge_channel(bgr: torch.Tensor, cfg: DTEdgeConfig = DTEdgeConfig(),
                    edt=edt_l2) -> torch.Tensor:
    """DT-Edge channel of a batch of BGR uint8 images [B, H, W, 3] ->
    uint8 [B, H, W], on the tensor's device. ``edt`` is the distance
    transform; ``ops.edt.edt_l2_plain`` gives the plain-version map."""
    edges, acc = edge_mask(bgr, cfg)
    dist = edt(edges)

    lohi = percentile_hw(dist, (1.0, 99.0))
    lo, hi = lohi[:, 0, None, None], lohi[:, 1, None, None]
    scale = torch.clamp_min(hi - lo, 1e-6)
    dnorm = torch.clamp((dist - lo) / scale, 0.0, 1.0)
    soft = torch.exp(-dnorm / cfg.tau)
    amn = acc.amin(dim=(-2, -1), keepdim=True)
    amx = acc.amax(dim=(-2, -1), keepdim=True)
    acc_nrm = (acc - amn) / torch.clamp_min(amx - amn, 1e-12)
    out = torch.clamp(0.7 * soft + 0.3 * acc_nrm, 0.0, 1.0)
    return torch.floor(out * 255.0).to(torch.uint8)


def build_multich(bgr: torch.Tensor, out_channels: int,
                  cfg: DTEdgeConfig = DTEdgeConfig()) -> torch.Tensor:
    """Network input (`Detect_OBB.py:87-133`): BGR uint8 [B, H, W, 3] ->
    float32 NCHW [B, C, H, W] in 0..255; 3ch is RGB, 4ch is RGB + DT-Edge."""
    rgb = bgr.flip(-1).to(torch.float32)
    if out_channels == 4:
        dt = dt_edge_channel(bgr, cfg).to(torch.float32)
        rgb = torch.cat([rgb, dt[..., None]], dim=-1)
    elif out_channels != 3:
        raise ValueError(f"channels must be 3 or 4, got {out_channels}")
    return rgb.permute(0, 3, 1, 2).contiguous()
