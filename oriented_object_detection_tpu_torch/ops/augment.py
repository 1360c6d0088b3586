"""Image augmentation on tensors and the label transforms that go with it,
the port of the JAX package's ``ops/augment.py``.

* train-time loader augmentation (engine defaults): horizontal flip and the
  HSV S/V jitter, batched on the device;
* the label math of the offline class-balancing augmentations
  (`Train_OBB.py:446-510`): scale x1.2 with the int-rounded new size, and
  integer shift with clip.

Colour conversions follow cv2's uint8 HSV ranges (H in 0..179). Every float
operation is the JAX package's, in its order, in float32, so the uint8
values come out bit for bit the same. XLA compiles a division by a constant
into a multiply by the constant's float32 reciprocal, so the port multiplies
where the JAX code divides by a constant.
"""

from __future__ import annotations

import numpy as np
import torch

INV_255 = float(np.float32(1.0 / 255.0))
INV_60 = float(np.float32(1.0 / 60.0))


def bgr_to_hsv_u8(bgr: torch.Tensor) -> torch.Tensor:
    """cv2 BGR(u8) -> HSV(u8) ranges: H 0..179, S/V 0..255, float32."""
    b, g, r = (bgr[..., i].to(torch.float32) for i in range(3))
    v = torch.maximum(torch.maximum(b, g), r)
    mn = torch.minimum(torch.minimum(b, g), r)
    diff = v - mn
    zero = torch.zeros_like(v)
    s = torch.where(v > 0, diff / torch.clamp_min(v, 1e-9) * 255.0, zero)
    safe = torch.clamp_min(diff, 1e-9)
    h = torch.where(
        v == r, 60.0 * (g - b) / safe,
        torch.where(v == g, 120.0 + 60.0 * (b - r) / safe,
                    240.0 + 60.0 * (r - g) / safe))
    h = torch.where(diff == 0, zero, h)
    h = torch.where(h < 0, h + 360.0, h) / 2.0  # cv2 packs H/2 for uint8
    return torch.stack([h, s, v], dim=-1)


def hsv_to_bgr_u8(hsv: torch.Tensor) -> torch.Tensor:
    h = hsv[..., 0] * 2.0
    s = hsv[..., 1] * INV_255
    v = hsv[..., 2]
    c = v * s
    hp = h * INV_60
    x = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    z = torch.zeros_like(c)
    idx = torch.floor(hp).to(torch.int32) % 6

    def select(*vals):
        # the first index that matches wins, the last value is the default
        out = vals[-1]
        for k in range(4, -1, -1):
            out = torch.where(idx == k, vals[k], out)
        return out

    r = select(c, x, z, z, x, c)
    g = select(x, c, c, x, z, z)
    b = select(z, z, x, c, c, x)
    m = v - c
    return torch.stack([b + m, g + m, r + m], dim=-1)


def hsv_jitter(bgr_u8: torch.Tensor, s_gain, v_gain) -> torch.Tensor:
    """S and V scaled by the gains and clipped (`Train_OBB.py:492-496`);
    returns a uint8-valued float32 image. The gains broadcast against
    [..., H, W]."""
    hsv = bgr_to_hsv_u8(bgr_u8)
    hsv = torch.stack([hsv[..., 0], hsv[..., 1] * s_gain,
                       hsv[..., 2] * v_gain], dim=-1)
    # the reference rounds through astype(uint8) after the clip: truncation
    hsv = torch.floor(torch.clamp(hsv, 0.0, 255.0))
    return torch.clamp(torch.round(hsv_to_bgr_u8(hsv)), 0, 255)


def fliplr_image(img: torch.Tensor) -> torch.Tensor:
    """Mirror [..., H, W, C] images horizontally."""
    return img.flip(-2)


def fliplr_corners8(c8: torch.Tensor, width: float) -> torch.Tensor:
    """Mirror OBB corner labels horizontally (pixel coords)."""
    out = c8.clone()
    out[..., 0::2] = width - c8[..., 0::2]
    return out


def scale_labels_norm(labels: torch.Tensor, w: int, h: int,
                      factor: float = 1.2):
    """`Train_OBB.py:462-471`: the scaled image size is int-rounded, so
    normalized labels move by w*f/int(w*f). Returns (labels, (nh, nw))."""
    nw, nh = int(w * factor), int(h * factor)
    out = labels.to(torch.float64).clone()
    out[..., 1::2] *= w * factor / nw
    out[..., 2::2] *= h * factor / nh
    out = torch.clamp(out, 0.0, 1.0)
    out[..., 0] = labels[..., 0]
    return out, (nh, nw)


def shift_labels_norm(labels: torch.Tensor, w: int, h: int,
                      dx: int, dy: int) -> torch.Tensor:
    """`Train_OBB.py:480-487`: denormalize, shift, renormalize, clip."""
    out = labels.to(torch.float64).clone()
    out[..., 1::2] = torch.clamp((out[..., 1::2] * w + dx) / w, 0.0, 1.0)
    out[..., 2::2] = torch.clamp((out[..., 2::2] * h + dy) / h, 0.0, 1.0)
    out[..., 0] = labels[..., 0]
    return out
