"""General image ops: letterbox and elastic transform.

* ``letterbox`` - the ultralytics aspect-preserving resize and pad-114 to a
  square, returning the scale and pad that map detections back (the
  single-crop predictor, ``TiledDetector.predict_crop``). The resize is the
  JAX package's ``jax.image.resize(..., "linear")``: a triangle filter,
  widened by the downscale factor when it downscales (antialias), with
  half-pixel centres, applied as one weight matrix per axis.
* ``elastic_transform`` - the reference's (disabled) elastic warp
  (`Train_OBB.py:431-443`): a Gaussian-filtered uniform displacement field
  and a bilinear remap. The draw of the field and the remap are split, so
  that the remap (``elastic_remap``) can be fed any field, such as the
  JAX package's own draws.
"""

from __future__ import annotations

import numpy as np
import torch

from .dtedge import _gaussian_kernel_1d, _sep_conv2d


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] weights of ``jax.image``'s linear resize along one axis
    (``compute_weight_mat`` with antialias), computed in float64 and
    rounded once to float32."""
    inv = n_in / n_out
    kernel_scale = max(inv, 1.0)
    sample = (np.arange(n_out) + 0.5) * inv - 0.5
    x = np.abs(sample[None, :] - np.arange(n_in)[:, None]) / kernel_scale
    w = np.maximum(0.0, 1.0 - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0).astype(np.float32)


def resize_linear(img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """[H, W, C] -> float32 [nh, nw, C], ``jax.image.resize(img, (nh, nw,
    C), "linear")``."""
    x = img.to(torch.float32)
    h, w = x.shape[:2]
    if nh != h:
        wh = torch.from_numpy(_resize_weights(h, nh))
        x = torch.einsum("hwc,hn->nwc", x, wh.to(x.device))
    if nw != w:
        ww = torch.from_numpy(_resize_weights(w, nw))
        x = torch.einsum("hwc,wn->hnc", x, ww.to(x.device))
    return x


def letterbox(img: torch.Tensor, new_size: int, pad_value: int = 114,
              scaleup: bool = True):
    """[H, W, C] -> (float32 [new, new, C], ratio, (dw, dh)).

    Resize preserving aspect to fit ``new_size``, centre-pad with
    ``pad_value``. Detections map back as (x - dw) / ratio. The sizes and
    the pad come from Python's ``round`` (half to even), as in the JAX
    package."""
    h, w = img.shape[:2]
    r = min(new_size / h, new_size / w)
    if not scaleup:
        r = min(r, 1.0)
    nh, nw = int(round(h * r)), int(round(w * r))
    resized = resize_linear(img, nh, nw)
    dh, dw = (new_size - nh) / 2, (new_size - nw) / 2
    top, left = int(round(dh - 0.1)), int(round(dw - 0.1))
    out = torch.full((new_size, new_size, img.shape[2]), float(pad_value),
                     dtype=torch.float32, device=img.device)
    out[top:top + nh, left:left + nw] = resized
    return out, r, (left, top)


def elastic_remap(img: torch.Tensor, dx: torch.Tensor, dy: torch.Tensor,
                  alpha: float, sigma: float) -> torch.Tensor:
    """Elastic warp of [H, W, C] by the raw displacement fields dx, dy
    [H, W]: each Gaussian-filtered (REFLECT_101) and scaled by ``alpha``,
    then a bilinear sample at the positions clamped to the image
    (``map_coordinates(order=1, mode="nearest")``). Returns float32."""
    h, w = img.shape[:2]
    kern = _gaussian_kernel_1d(max(sigma, 0.1))
    dx = _sep_conv2d(dx.to(torch.float32)[None], kern, kern)[0] * alpha
    dy = _sep_conv2d(dy.to(torch.float32)[None], kern, kern)[0] * alpha
    ys = torch.clamp(torch.arange(h, dtype=torch.float32,
                                  device=img.device)[:, None] + dy, 0, h - 1)
    xs = torch.clamp(torch.arange(w, dtype=torch.float32,
                                  device=img.device)[None, :] + dx, 0, w - 1)
    y0, x0 = torch.floor(ys), torch.floor(xs)
    wy1, wx1 = ys - y0, xs - x0
    wy0, wx0 = 1.0 - wy1, 1.0 - wx1
    y0, x0 = y0.long(), x0.long()
    y1, x1 = torch.clamp_max(y0 + 1, h - 1), torch.clamp_max(x0 + 1, w - 1)
    src = img.to(torch.float32)
    out = None
    # the corners in map_coordinates' order, each weight product first
    for yi, wy in ((y0, wy0), (y1, wy1)):
        for xi, wx in ((x0, wx0), (x1, wx1)):
            term = (wy * wx)[..., None] * src[yi, xi]
            out = term if out is None else out + term
    return out


def elastic_transform(img: torch.Tensor, generator: torch.Generator,
                      alpha: float | None = None,
                      sigma: float | None = None) -> torch.Tensor:
    """Elastic warp of [H, W, C] (the reference's semantics): two U(-1, 1)
    fields drawn from ``generator``, then ``elastic_remap``."""
    h, w = img.shape[:2]
    if alpha is None:
        alpha = min(h, w) * 0.03
    if sigma is None:
        sigma = alpha * 0.1
    dx, dy = (torch.rand((h, w), generator=generator,
                         device=generator.device) * 2.0 - 1.0
              for _ in range(2))
    return elastic_remap(img, dx.to(img.device), dy.to(img.device), alpha,
                         sigma)
