"""Checkpoints: load the JAX package's pickled checkpoints with numpy alone,
turn their flax variable trees into this package's state dicts, and turn
state dicts back into flax trees, so that a checkpoint the port writes is
one the JAX package reads.

A checkpoint is a pickle of {'step', 'params', 'batch_stats',
'ema_params', 'opt_state', 'extra'} nested dicts of numpy arrays (the JAX
package's ``train/trainer.py``). The flax paths are renamed to ultralytics
keys and conv kernels transposed HWIO -> OIHW, as the JAX package's
``models/weights.py`` exports them, and back. RTMDet-R's keys are
mmrotate's (``backbone.``, ``neck.``, ``bbox_head.``): its flax path is the
key's dotted parts with the leaf renamed (``conv.weight`` ->
``conv/kernel``, ``bn.weight`` -> ``bn/scale``, ``bn.running_var`` ->
``bn/var`` under ``batch_stats``).
"""

from __future__ import annotations

import pickle
import re

import numpy as np
import torch


# flax conv kernels are HWIO, the port's OIHW: axis i of a port kernel is
# axis KERNEL_AXES[i] of the flax kernel
KERNEL_AXES = (3, 2, 0, 1)
# the OBB head's layer: 23 in YOLO11, 21 in YOLO12 (neither has a layer
# with parameters at the other's index)
HEAD_LAYERS = ("21", "23")
# the first part of every RTMDet-R key (``models/rtmdet_r.py``)
MMROTATE_ROOTS = ("backbone", "neck", "bbox_head")
_MMROTATE_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias",
                    "mean": "running_mean", "var": "running_var"}
_FLAX_KERNEL_AXES = tuple(int(a) for a in np.argsort(KERNEL_AXES))


def torch_axis(name: str, ndim: int, flax_axis: int) -> int:
    """The axis of the port's tensor ``name`` (``ndim`` dimensions) that
    holds axis ``flax_axis`` (negative counts from the end) of its flax
    leaf: a conv kernel (a 4-D ``weight``) goes through ``KERNEL_AXES``,
    every other leaf keeps its axes."""
    axis = flax_axis % ndim
    if name.endswith("weight") and ndim == len(KERNEL_AXES):
        return KERNEL_AXES.index(axis)
    return axis


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
    if path[0] in MMROTATE_ROOTS:
        if leaf not in _MMROTATE_LEAVES:
            return None
        return ".".join(path[:-1] + [_MMROTATE_LEAVES[leaf]])
    for p in path[:-1]:
        m = re.match(r"^l(\d+)$", p)
        if m:
            parts.append(f"model.{m.group(1)}")
            continue
        hm = re.match(r"^cv([234])_(\d+)_(\d+)(?:_(\d+))?$", p)
        if hm and parts and parts[0] in [f"model.{i}" for i in HEAD_LAYERS]:
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
    if leaf == "gamma":                        # YOLO12's A2C2f residual scale
        return name + ".gamma"
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
            out[key] = val.transpose(KERNEL_AXES) if k == "kernel" else val

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
    if parts[0] in MMROTATE_ROOTS and len(parts) > 2:
        path, leaf = parts[:-1], parts[-1]
        if path[-1] == "bn" and leaf in _BN_LEAVES:
            coll, name = _BN_LEAVES[leaf]
            return coll, path + [name]
        if leaf in ("weight", "bias") and path[-1] != "bn":
            return "params", path + [{"weight": "kernel"}.get(leaf, leaf)]
        raise KeyError(f"no flax path for torch key {key}")
    if parts[0] != "model" or len(parts) < 3:
        raise KeyError(f"no flax path for torch key {key}")
    path, rest = [f"l{parts[1]}"], parts[2:-1]
    leaf = parts[-1]
    if parts[1] in HEAD_LAYERS:                # the OBB head
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
    if leaf == "gamma" and not rest:           # YOLO12's A2C2f.gamma
        return "params", path + ["gamma"]
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
        a = a.astype(np.float32)
        if path[-1] == "kernel":
            a = a.transpose(_FLAX_KERNEL_AXES)
        a = np.ascontiguousarray(a)
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


# ---------------------------------------------------------------------------
# Ultralytics checkpoints: ``convert`` and its inverse
# ---------------------------------------------------------------------------

_CONV_BN_TAILS = {"conv.weight": "kernel", "conv.bias": "bias",
                  "bn.weight": "scale", "bn.bias": "bn_bias",
                  "bn.running_mean": "mean", "bn.running_var": "var"}
_TAIL_PARTS = ("conv", "bn", "weight", "bias", "running_mean", "running_var")


def _ultralytics_key_to_flax(key: str) -> tuple[list[str], str] | None:
    """One ultralytics state-dict key -> (flax path, kind), the JAX
    package's ``convert`` parser: kind is 'kernel', 'bias', 'scale',
    'bn_bias', 'mean' or 'var'; None for a key the model has no array for
    (``num_batches_tracked``, the upsamples, the fixed DFL conv)."""
    if key.endswith("num_batches_tracked"):
        return None
    key = re.sub(r"^model\.", "", key)
    m = re.match(r"^(\d+)\.(.*)$", key)
    if not m:
        return None
    layer, rest = int(m.group(1)), m.group(2)
    if layer in (11, 14):  # Upsample: no params
        return None
    path = [f"l{layer}"]
    if layer == 23:
        # the head: cv2/cv3/cv4 . level . stage . ...
        hm = re.match(r"^cv([234])\.(\d+)\.(\d+)\.(.*)$", rest)
        if hm is None:
            return None  # dfl.conv.weight: fixed bins
        branch, lvl, stage, tail = hm.groups()
        if tail in ("weight", "bias"):
            # the final plain Conv2d
            path.append(f"cv{branch}_{lvl}_{stage}")
            return path, ("kernel" if tail == "weight" else "bias")
        if branch == "3":
            # cv3.{lvl}.{a}.{b}.<ConvBN tail>: (DWConv, Conv) pairs
            sm = re.match(r"^(\d+)\.(.*)$", tail)
            if sm is None:
                return None
            sub, tail = sm.groups()
            path.append(f"cv3_{lvl}_{stage}_{sub}")
            if sub == "0":  # the DWConv wraps its ConvBN under 'dw'
                path.append("dw")
        else:
            path.append(f"cv{branch}_{lvl}_{stage}")
        rest = tail
    else:
        # the module tree: cvN / m.J / attn / ffn.K / qkv / proj / pe
        parts = rest.split(".")
        rest = None
        i = 0
        while i < len(parts):
            p = parts[i]
            if p in ("m", "ffn") and i + 1 < len(parts) \
                    and parts[i + 1].isdigit():
                path.append(f"{p}_{parts[i + 1]}")
                i += 2
            elif p in _TAIL_PARTS:
                rest = ".".join(parts[i:])
                break
            else:
                path.append(p)
                i += 1
        if rest is None:
            return None
    kind = _CONV_BN_TAILS.get(rest)
    if kind is None:
        return None
    return path + (["conv"] if kind in ("kernel", "bias") else ["bn"]), kind


def convert_state_dict(sd: dict, reverse_stem_channels: bool = False
                       ) -> dict:
    """Ultralytics state dict {key: numpy array} -> flax {'params',
    'batch_stats'} trees (the JAX package's ``convert_state_dict``): conv
    weights OIHW -> HWIO (depthwise [C, 1, kh, kw] -> [kh, kw, 1, C]), the
    stem's input channels reversed for a 4-channel model, BN ``weight`` and
    ``bias`` -> ``scale`` and ``bias``, the running statistics -> ``mean``
    and ``var``. Keys the model has no array for are skipped, and every
    array keeps its dtype."""
    params: dict = {}
    stats: dict = {}
    leaf = {"kernel": (params, "kernel"), "bias": (params, "bias"),
            "scale": (params, "scale"), "bn_bias": (params, "bias"),
            "mean": (stats, "mean"), "var": (stats, "var")}
    for key, val in sd.items():
        trans = _ultralytics_key_to_flax(key)
        if trans is None:
            continue
        path, kind = trans
        v = np.asarray(val)
        if kind == "kernel":
            v = v.transpose(2, 3, 1, 0)
            if reverse_stem_channels and path[0] == "l0":
                v = v[:, :, ::-1, :]
        tree, name = leaf[kind]
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node.setdefault(path[-1], {})[name] = v
    return {"params": params, "batch_stats": stats}


def _flatten(tree: dict, prefix: tuple = ()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def validate_against(variables_converted: dict, variables_model: dict
                     ) -> dict:
    """Coverage of a model's flax variables by converted ones:
    {'matched': n, 'missing': [path], 'extra': [path], 'mismatched':
    [(path, converted shape, model shape)]}. The model's variables are
    ``jax_trees_from_torch_state`` of a fresh ``YOLO11OBB`` of the target
    shape."""
    conv = _flatten(variables_converted["params"])
    conv.update(_flatten(variables_converted["batch_stats"]))
    ref = _flatten(dict(variables_model["params"]))
    ref.update(_flatten(dict(variables_model.get("batch_stats", {}))))
    missing = [k for k in ref if k not in conv]
    extra = [k for k in conv if k not in ref]
    mismatched = [(k, tuple(np.shape(conv[k])), tuple(np.shape(ref[k])))
                  for k in ref
                  if k in conv and np.shape(conv[k]) != np.shape(ref[k])]
    return {"matched": len(ref) - len(missing), "missing": missing,
            "extra": extra, "mismatched": mismatched}


def export_state_dict(variables: dict, reverse_stem_channels: bool = False
                      ) -> dict:
    """The inverse of ``convert_state_dict``: flax variables ->
    ultralytics-keyed {key: numpy array}, each array in its own dtype."""
    out: dict = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + [k])
                continue
            key = _flax_path_to_torch(path + [k])
            if key is None:
                continue
            val = np.asarray(v)
            if k == "kernel":  # HWIO -> OIHW
                if reverse_stem_channels and path and path[0] == "l0":
                    val = val[:, :, ::-1, :]
                val = val.transpose(3, 2, 0, 1)
            out[key] = val

    walk(dict(variables["params"]), [])
    walk(dict(variables.get("batch_stats", {})), [])
    return out
