"""Checkpoint reader of the plain reference: the committed pickles (nested
dicts of numpy arrays in flax's layout, fp16- or int8-distilled) to an
ultralytics-keyed float32 state dict with OIHW conv kernels. Numpy only;
reads the raw file itself and shares nothing with the program."""

from __future__ import annotations

import pickle
import re

import numpy as np

# flax HWIO kernel -> OIHW
KERNEL_AXES = (3, 2, 0, 1)


def _map_tree(fn, tree, path: str = ""):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, f"{path}[{k!r}]") for k, v in tree.items()}
    return fn(path, tree)


def _float32(_path, a):
    return np.asarray(a, np.float32) if getattr(a, "dtype", None) in (
        np.float16, np.float32, np.float64) else a


def load(path: str) -> dict:
    """{'params', 'batch_stats', 'extra'} of a checkpoint, the parameters
    float32: an int8 leaf is multiplied by its per-output-channel
    ``q_scales`` vector (keyed by the leaf's key string); a leaf left int8
    or a scale left unused raises."""
    with open(path, "rb") as f:
        ck = pickle.load(f)
    scales = ck.get("q_scales") or {}
    used = set()

    def leaf(key, a):
        s = scales.get(key)
        if s is not None:
            used.add(key)
            return np.asarray(a, np.float32) * np.asarray(s, np.float32)
        if getattr(a, "dtype", None) == np.int8:
            raise ValueError(f"{path}: int8 leaf {key} has no scale")
        return _float32(key, a)

    params = _map_tree(leaf, ck["params"])
    if set(scales) - used:
        raise ValueError(f"{path}: unused scales {sorted(set(scales) - used)[:3]}")
    return {"params": params,
            "batch_stats": _map_tree(_float32, ck["batch_stats"]),
            "extra": ck.get("extra") or {}}


def _torch_key(path: list) -> str:
    parts, leaf = [], path[-1]
    for p in path[:-1]:
        m = re.match(r"^l(\d+)$", p)
        hm = re.match(r"^cv([234])_(\d+)_(\d+)(?:_(\d+))?$", p)
        mm = re.match(r"^(m|ffn)_(\d+)$", p)
        if m:
            parts.append(f"model.{m.group(1)}")
        elif hm and parts and parts[0].endswith(".23"):
            b, lvl, st, sub = hm.groups()
            parts.append(f"cv{b}.{lvl}.{st}" + (f".{sub}" if sub else ""))
        elif mm:
            parts.append(f"{mm.group(1)}.{mm.group(2)}")
        elif p != "dw":
            parts.append(p)
    name = ".".join(parts)
    plain = re.search(r"cv[234]\.\d+\.\d+$", name) is not None
    if leaf == "kernel":
        return name + (".weight" if name.endswith("conv") or plain
                       else ".conv.weight")
    if leaf == "bias" and (name.endswith("conv") or plain):
        return name + ".bias"
    return {"scale": name + ".weight", "bias": name + ".bias",
            "mean": name + ".running_mean", "var": name + ".running_var"}[leaf]


def state_dict(ck: dict) -> dict:
    """Ultralytics-keyed {name: float32 numpy} of a ``load`` result."""
    out = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + [k])
                continue
            a = np.asarray(v, np.float32)
            out[_torch_key(path + [k])] = (a.transpose(KERNEL_AXES)
                                           if k == "kernel" else a)

    walk(ck["params"], [])
    walk(ck["batch_stats"], [])
    return out
