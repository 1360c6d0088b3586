"""Inference-time Conv+BN folding (the engine's ``fuse()`` step) on an
ultralytics-keyed state dict of numpy arrays:

    inv      = weight / sqrt(running_var + eps)
    conv'    = conv * inv        (OIHW: out channel first)
    bias'    = bias - running_mean * inv
    weight'=1, mean'=0, var'=1-eps    => BN(x) == x + bias'

so a ConvBN with ``fused=True`` computes conv'(x) + bias'. Every other
entry, such as YOLO12's ``gamma``, is passed on as it is. The arithmetic
is the JAX package's ``models/fold.py`` (float64, cast back), so both
packages fold to the same float32 weights.
"""

from __future__ import annotations

import numpy as np

from .layers import BN_EPS


def fold_bn_state(state: dict, eps: float = BN_EPS) -> dict:
    """New state dict with every ``P.conv.weight`` / ``P.bn.*`` pair folded.
    The input is not modified."""
    out = dict(state)
    for key in state:
        if not key.endswith(".conv.weight"):
            continue
        p = key[:-len("conv.weight")]
        if p + "bn.running_var" not in state:
            continue
        k = np.asarray(state[key])
        scale = np.asarray(state[p + "bn.weight"], np.float64)
        mean = np.asarray(state[p + "bn.running_mean"], np.float64)
        var = np.asarray(state[p + "bn.running_var"], np.float64)
        bias = np.asarray(state[p + "bn.bias"], np.float64)
        inv = scale / np.sqrt(var + eps)
        f32 = np.float32
        out[key] = (k.astype(np.float64) * inv[:, None, None, None]).astype(
            k.dtype)
        out[p + "bn.weight"] = np.ones_like(scale, dtype=f32)
        out[p + "bn.bias"] = (bias - mean * inv).astype(f32)
        out[p + "bn.running_mean"] = np.zeros_like(mean, dtype=f32)
        out[p + "bn.running_var"] = np.full_like(var, 1.0 - eps, dtype=f32)
    return out
