"""Checkpoints: load the JAX package's pickled checkpoints with numpy alone,
turn their flax variable trees into this package's state dicts, and turn
state dicts back into flax trees, so that a checkpoint the port writes is
one the JAX package reads.

A checkpoint is a pickle of {'step', 'params', 'batch_stats',
'ema_params', 'opt_state', 'extra'} nested dicts of numpy arrays (the JAX
package's ``train/trainer.py``). The flax paths are renamed to ultralytics
keys and conv kernels transposed HWIO -> OIHW, as the JAX package's
``models/weights.py`` exports them, and back.
"""

from __future__ import annotations

import pickle
import re

import numpy as np
import torch


def _map_tree(fn, tree, path: str = ""):
    """Apply ``fn(path, leaf)`` to every leaf of a nested dict; ``path`` is
    the leaf's key string as jax's ``keystr`` writes it
    (``"['l1']['conv']['kernel']"``)."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, f"{path}[{k!r}]")
                for k, v in tree.items()}
    return fn(path, tree)


def _upcast_fp16(_path, a):
    return a.astype(np.float32) \
        if getattr(a, "dtype", None) == np.float16 else a


def _dequantize_int8(params: dict, q_scales: dict, path: str) -> dict:
    """Per-output-channel int8 params back to float32: each int8 leaf times
    its ``q_scales`` vector, the fp16 rest upcast (the JAX package's
    ``train/trainer.py::load_checkpoint``). Raises if a scale matches no
    leaf or an int8 leaf has no scale: either would leave a kernel
    unscaled and the forward silently wrong."""
    used = set()

    def leaf(key, a):
        s = q_scales.get(key)
        if s is not None:
            used.add(key)
            return np.asarray(a, np.float32) * s
        if getattr(a, "dtype", None) == np.int8:
            raise ValueError(f"{path}: int8 leaf {key} has no q_scales entry")
        return _upcast_fp16(key, a)

    out = _map_tree(leaf, params)
    unused = sorted(set(q_scales) - used)
    if unused:
        raise ValueError(f"{path}: q_scales keys match no parameter: "
                         f"{unused[:4]}")
    return out


def load_checkpoint(path: str) -> dict:
    """Unpickle a checkpoint; fp16- and int8-distilled parameters come back
    as fp32. Only load checkpoints from a trusted source: unpickling runs
    code."""
    with open(path, "rb") as f:
        ck = pickle.load(f)
    extra = ck.get("extra", {})
    if extra.get("distilled_fp16"):
        ck["params"] = _map_tree(_upcast_fp16, ck["params"])
        if ck.get("ema_params") is not None:
            ck["ema_params"] = _map_tree(_upcast_fp16, ck["ema_params"])
    elif extra.get("distilled_int8"):
        ck["params"] = _dequantize_int8(ck["params"], ck.pop("q_scales"),
                                        path)
    return ck


def variables_from_checkpoint(ck, use_ema: bool = True) -> dict:
    """Inference variables {'params', 'batch_stats'} of a checkpoint (a
    path, or a dict from ``load_checkpoint``): EMA weights when it has
    them, like the engine's best.pt."""
    if isinstance(ck, str):
        ck = load_checkpoint(ck)
    params = ck["ema_params"] if use_ema and ck.get("ema_params") is not None \
        else ck["params"]
    return {"params": params, "batch_stats": ck["batch_stats"]}


def _flax_path_to_torch(path: list[str]) -> str | None:
    parts = []
    leaf = path[-1]
    for p in path[:-1]:
        m = re.match(r"^l(\d+)$", p)
        if m:
            parts.append(f"model.{m.group(1)}")
            continue
        hm = re.match(r"^cv([234])_(\d+)_(\d+)(?:_(\d+))?$", p)
        if hm and parts and parts[0].endswith(".23"):
            b, lvl, st, sub = hm.groups()
            parts.append(f"cv{b}.{lvl}.{st}" + (f".{sub}" if sub else ""))
            continue
        mm = re.match(r"^(m|ffn)_(\d+)$", p)
        if mm:
            parts.append(f"{mm.group(1)}.{mm.group(2)}")
            continue
        if p == "dw":
            continue  # the DWConv wrapper is transparent in torch naming
        parts.append(p)
    name = ".".join(parts)
    plain_head_conv = re.search(r"cv[234]\.\d+\.\d+$", name) is not None
    if leaf == "kernel":
        if name.endswith("conv") or plain_head_conv:
            return name + ".weight"
        return name + ".conv.weight"
    if leaf == "bias" and (name.endswith("conv") or plain_head_conv):
        return name + ".bias"
    return {"scale": name + ".weight", "bias": name + ".bias",
            "mean": name + ".running_mean",
            "var": name + ".running_var"}.get(leaf)


def torch_state_from_jax(variables: dict) -> dict:
    """flax {'params', 'batch_stats'} numpy tree -> ultralytics-keyed
    state dict of float32 numpy arrays (conv kernels OIHW)."""
    out: dict = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + [k])
                continue
            key = _flax_path_to_torch(path + [k])
            if key is None:
                raise KeyError(f"no torch key for flax path "
                               f"{'/'.join(path + [k])}")
            val = np.asarray(v, np.float32)
            out[key] = val.transpose(3, 2, 0, 1) if k == "kernel" else val

    walk(dict(variables["params"]), [])
    walk(dict(variables.get("batch_stats", {})), [])
    return out


_BN_LEAVES = {"weight": ("params", "scale"), "bias": ("params", "bias"),
              "running_mean": ("batch_stats", "mean"),
              "running_var": ("batch_stats", "var")}


def _torch_key_to_flax(key: str) -> tuple[str, list[str]]:
    """Inverse of ``_flax_path_to_torch``: an ultralytics key -> (flax
    collection, path). Raises for a key with no flax leaf."""
    parts = key.split(".")
    if parts[0] != "model" or len(parts) < 3:
        raise KeyError(f"no flax path for torch key {key}")
    path, rest = [f"l{parts[1]}"], parts[2:-1]
    leaf = parts[-1]
    if parts[1] == "23":                       # the OBB head
        branch, lvl, st = rest[0], rest[1], rest[2]
        sub = rest[3] if len(rest) > 3 and rest[3].isdigit() else None
        path.append(f"{branch}_{lvl}_{st}" + (f"_{sub}" if sub else ""))
        if branch == "cv3" and sub == "0":     # the depthwise ConvBN
            path.append("dw")
        rest = rest[4 if sub else 3:]
    j = 0
    while j < len(rest):
        if rest[j] in ("m", "ffn") and j + 1 < len(rest) \
                and rest[j + 1].isdigit():
            path.append(f"{rest[j]}_{rest[j + 1]}")
            j += 2
        else:
            path.append(rest[j])
            j += 1
    if path[-1] == "bn":
        if leaf not in _BN_LEAVES:
            raise KeyError(f"no flax path for torch key {key}")
        coll, name = _BN_LEAVES[leaf]
        return coll, path + [name]
    if leaf == "weight":
        return "params", path + ["kernel"]
    if leaf == "bias":
        return "params", path + ["bias"]
    raise KeyError(f"no flax path for torch key {key}")


def jax_trees_from_torch_state(state: dict) -> dict:
    """Ultralytics-keyed state dict (numpy or tensors) -> flax
    {'params', 'batch_stats'} numpy trees, conv kernels OIHW -> HWIO;
    BatchNorm's ``num_batches_tracked`` is dropped. Every key is checked to
    map back to itself through ``torch_state_from_jax``'s renaming."""
    trees: dict = {"params": {}, "batch_stats": {}}
    for key, val in state.items():
        if key.endswith("num_batches_tracked"):
            continue
        coll, path = _torch_key_to_flax(key)
        if _flax_path_to_torch(path) != key:
            raise KeyError(f"torch key {key} maps to {'/'.join(path)}, "
                           f"which maps back to {_flax_path_to_torch(path)}")
        a = val.detach().cpu().numpy() if isinstance(val, torch.Tensor) \
            else np.asarray(val)
        a = np.ascontiguousarray(a.astype(np.float32).transpose(2, 3, 1, 0)
                                 if path[-1] == "kernel" else
                                 a.astype(np.float32))
        node = trees[coll]
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = a
    return trees


def load_state(model: torch.nn.Module, state: dict) -> None:
    """Copy a numpy state dict into ``model``; every parameter and BN
    statistic must be present with its shape (BatchNorm's
    ``num_batches_tracked`` counters are not used at inference)."""
    res = model.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
         state.items()}, strict=False)
    missing = [k for k in res.missing_keys
               if not k.endswith("num_batches_tracked")]
    if missing or res.unexpected_keys:
        raise KeyError(f"state dict mismatch: missing {missing[:8]}, "
                       f"unexpected {res.unexpected_keys[:8]}")
