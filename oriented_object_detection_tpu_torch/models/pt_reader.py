"""Reader of torch zip-format checkpoints (``.pt``) into numpy, which runs
no code from the file.

The reference serves fine-tuned ultralytics checkpoints (`Detect_OBB.py:26`,
`Train_OBB.py:792`). Their pickle stream names ultralytics classes, so
``torch.load(weights_only=True)`` refuses them, and a full unpickle would
need ultralytics installed and would run whatever the file's pickle calls.
This module reads the format itself (the JAX package's
``models/pt_reader.py``, kept here as the port's own copy):

* a ``.pt`` is a zip: ``<name>/data.pkl`` (the pickle program),
  ``<name>/data/<key>`` (one raw little-endian storage per entry),
  ``<name>/version`` and maybe ``<name>/byteorder``;
* storages are pickled as persistent ids ``('storage', <StorageType>, key,
  location, numel)``, and tensors rebuilt by
  ``torch._utils._rebuild_tensor_v2(storage, offset, size, stride, ...)``;
* every other global (ultralytics modules, torch layers, argparse
  namespaces, ...) becomes an inert stub that only records its arguments
  and state.

A tensor's view is checked against its storage before it is taken: a
negative offset, size or stride, a view that reaches past the storage's
declared element count, or a storage entry shorter than that count raises
``pickle.UnpicklingError``, as does a module graph that is cyclic or
deeper than ``MAX_MODULE_DEPTH``.
"""

from __future__ import annotations

import builtins
import collections
import pickle
import zipfile
from collections import OrderedDict
from typing import Dict

import numpy as np

MAX_MODULE_DEPTH = 64

# torch storage class name -> numpy dtype of the raw bytes in data/<key>;
# bfloat16 is read as its uint16 bit patterns and widened to float32
_STORAGE_DTYPES = {
    "FloatStorage": np.dtype("<f4"),
    "DoubleStorage": np.dtype("<f8"),
    "HalfStorage": np.dtype("<f2"),
    "BFloat16Storage": np.dtype("<u2"),
    "LongStorage": np.dtype("<i8"),
    "IntStorage": np.dtype("<i4"),
    "ShortStorage": np.dtype("<i2"),
    "CharStorage": np.dtype("<i1"),
    "ByteStorage": np.dtype("<u1"),
    "BoolStorage": np.dtype("?"),
    "UntypedStorage": np.dtype("<u1"),
}

# real globals the pickle stream may need: numpy arrays (ultralytics keeps
# class-name arrays and metrics) rebuild through these; everything else
# becomes a stub
_SAFE_GLOBALS = {
    ("collections", "OrderedDict"): OrderedDict,
    ("collections", "defaultdict"): collections.defaultdict,
    ("numpy", "ndarray"): np.ndarray,
    ("numpy", "dtype"): np.dtype,
}
try:  # numpy 2 moved the private reconstruct helpers to numpy._core
    from numpy._core import multiarray as _ma
except ImportError:  # pragma: no cover - numpy 1
    from numpy.core import multiarray as _ma
for _mod in ("numpy.core.multiarray", "numpy._core.multiarray"):
    _SAFE_GLOBALS[(_mod, "_reconstruct")] = _ma._reconstruct
    _SAFE_GLOBALS[(_mod, "scalar")] = _ma.scalar
for _b in ("set", "frozenset", "complex", "bytearray", "range", "slice"):
    _SAFE_GLOBALS[("builtins", _b)] = getattr(builtins, _b)


class _StorageType:
    """Marker for the ``torch.<X>Storage`` globals of persistent ids."""

    def __init__(self, name: str):
        self.name = name
        self.dtype = _STORAGE_DTYPES.get(name)


class _Storage:
    """Lazy view of one ``data/<key>`` entry as a 1-D numpy array of its
    declared ``numel`` elements."""

    def __init__(self, zf: zipfile.ZipFile, entry: str, name: str,
                 dtype: np.dtype, numel: int):
        self._zf, self._entry = zf, entry
        self.name, self.dtype, self.numel = name, dtype, numel
        self._arr = None

    def array(self) -> np.ndarray:
        if self._arr is None:
            raw = self._zf.read(self._entry)
            if len(raw) < self.numel * self.dtype.itemsize:
                raise pickle.UnpicklingError(
                    f"storage {self._entry} holds {len(raw)} bytes, fewer "
                    f"than its {self.numel} elements need")
            self._arr = np.frombuffer(raw, self.dtype, count=self.numel)
        return self._arr


class _Stub:
    """Inert placeholder for a global the reader does not know: records its
    constructor arguments and pickled state, and runs no code of the
    checkpoint."""

    _qualname = "?"

    def __new__(cls, *args, **kwargs):  # NEWOBJ passes ctor args here
        return object.__new__(cls)

    def __init__(self, *args, **kwargs):
        self._stub_args = args
        self._stub_kwargs = kwargs

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        elif isinstance(state, tuple) and len(state) == 2:
            d, slots = state
            if isinstance(d, dict):
                self.__dict__.update(d)
            if isinstance(slots, dict):
                self.__dict__.update(slots)
        else:
            self.__dict__["_stub_state"] = state

    def __call__(self, *args, **kwargs):
        # a stubbed function or class used as a factory in REDUCE
        out = _Stub()
        out.__dict__["_stub_call"] = (self._qualname, args, kwargs)
        return out

    def __repr__(self):  # pragma: no cover - debugging aid
        return f"<stub {self._qualname}>"


def _rebuild_tensor_v2(storage: _Storage, offset, size, stride,
                       requires_grad=False, backward_hooks=None,
                       metadata=None) -> np.ndarray:
    """``torch._utils._rebuild_tensor_v2`` without torch: the strided view
    of the storage, bounds-checked, copied out contiguous."""
    if not isinstance(storage, _Storage):
        raise pickle.UnpicklingError("a tensor without a storage")
    offset = int(offset)
    size = tuple(int(s) for s in size)
    stride = tuple(int(s) for s in stride)
    if len(size) != len(stride):
        raise pickle.UnpicklingError(f"size {size} and stride {stride} "
                                     f"differ in rank")
    if offset < 0 or any(s < 0 for s in size) or any(s < 0 for s in stride):
        raise pickle.UnpicklingError(
            f"negative offset, size or stride: {offset}, {size}, {stride}")
    if all(s > 0 for s in size):
        last = offset + sum((s - 1) * st for s, st in zip(size, stride))
        if last + 1 > storage.numel:
            raise pickle.UnpicklingError(
                f"a view of size {size}, stride {stride} at offset "
                f"{offset} reaches element {last} of a storage of "
                f"{storage.numel}")
    elif offset > storage.numel:
        raise pickle.UnpicklingError(f"offset {offset} past a storage of "
                                     f"{storage.numel}")
    arr = storage.array()
    view = np.lib.stride_tricks.as_strided(
        arr[offset:], shape=size,
        strides=tuple(s * arr.itemsize for s in stride))
    out = view.copy()  # .copy(), not ascontiguousarray: keeps 0-d as 0-d
    if storage.name == "BFloat16Storage":
        out = (out.astype(np.uint32) << 16).view(np.float32)
    return out


def _rebuild_tensor(storage, offset, size, stride):
    return _rebuild_tensor_v2(storage, offset, size, stride)


def _rebuild_parameter(data, requires_grad=False, backward_hooks=None):
    return data


def _rebuild_parameter_with_state(data, requires_grad, hooks, state):
    return data


_REBUILDERS = {
    "_rebuild_tensor_v2": _rebuild_tensor_v2,
    "_rebuild_tensor": _rebuild_tensor,
    "_rebuild_parameter": _rebuild_parameter,
    "_rebuild_parameter_with_state": _rebuild_parameter_with_state,
}


class _RestrictedUnpickler(pickle.Unpickler):
    def __init__(self, file, zf: zipfile.ZipFile, prefix: str):
        super().__init__(file)
        self._zf = zf
        self._prefix = prefix
        self._storages: dict = {}

    def find_class(self, module: str, name: str):
        real = _SAFE_GLOBALS.get((module, name))
        if real is not None:
            return real
        if module == "torch._utils" and name in _REBUILDERS:
            return _REBUILDERS[name]
        if (module == "torch" or module.startswith("torch.storage")) \
                and name in _STORAGE_DTYPES:
            return _StorageType(name)
        if module == "torch" and name == "Size":
            return tuple
        # anything else (ultralytics and torch classes, functions, dtypes)
        # becomes an inert stub that records its name
        return type(f"stub_{name}", (_Stub,),
                    {"_qualname": f"{module}.{name}"})

    def persistent_load(self, pid):
        if not (isinstance(pid, tuple) and len(pid) >= 5
                and pid[0] == "storage"):
            raise pickle.UnpicklingError(
                f"unsupported persistent id: {pid!r}")
        storage_type, key, numel = pid[1], pid[2], pid[4]
        if key in self._storages:
            return self._storages[key]
        if isinstance(storage_type, _StorageType):
            dtype, tname = storage_type.dtype, storage_type.name
        else:  # a stubbed storage class
            dtype, tname = None, getattr(storage_type, "_qualname", "?")
        if dtype is None:
            raise pickle.UnpicklingError(f"unsupported storage type {tname}")
        if int(numel) < 0:
            raise pickle.UnpicklingError(f"storage {key}: negative numel")
        st = _Storage(self._zf, f"{self._prefix}data/{key}", tname, dtype,
                      int(numel))
        self._storages[key] = st
        return st


def read_pt(path: str):
    """Unpickle a torch zip-format checkpoint without torch. Returns the
    (partly stubbed) object graph; tensors are numpy arrays."""
    if not zipfile.is_zipfile(path):
        raise ValueError(
            f"{path} is not a torch zip-format checkpoint (legacy "
            "pre-torch-1.6 serialization is not supported; re-save with "
            "a modern torch or export an .npz state dict)")
    with zipfile.ZipFile(path) as zf:
        names = zf.namelist()
        pkl = [n for n in names if n == "data.pkl"
               or n.endswith("/data.pkl")]
        if not pkl:
            raise ValueError(f"{path}: no data.pkl entry, not a torch "
                             "checkpoint archive")
        prefix = pkl[0][: -len("data.pkl")]
        bo = f"{prefix}byteorder"
        if bo in names and zf.read(bo).decode().strip() != "little":
            raise ValueError(f"{path}: big-endian checkpoints unsupported")
        with zf.open(pkl[0]) as f:
            # the rebuilders copy every tensor out while the archive is open
            return _RestrictedUnpickler(f, zf, prefix).load()


def _module_state_dict(mod, prefix: str = "", ancestors: tuple = ()
                       ) -> "OrderedDict":
    """Walk a stubbed ``nn.Module`` graph as ``nn.Module.state_dict()``
    does: own ``_parameters`` and ``_buffers``, then ``_modules`` under
    dotted prefixes. A module that contains itself, or a graph deeper than
    ``MAX_MODULE_DEPTH``, raises ``pickle.UnpicklingError``."""
    if id(mod) in ancestors:
        raise pickle.UnpicklingError(f"cyclic module graph at {prefix!r}")
    if len(ancestors) >= MAX_MODULE_DEPTH:
        raise pickle.UnpicklingError(f"module graph deeper than "
                                     f"{MAX_MODULE_DEPTH} at {prefix!r}")
    ancestors = ancestors + (id(mod),)
    sd: "OrderedDict" = OrderedDict()
    d = getattr(mod, "__dict__", {})
    for name, p in (d.get("_parameters") or {}).items():
        if p is not None:
            sd[prefix + name] = p
    for name, b in (d.get("_buffers") or {}).items():
        if b is not None:
            sd[prefix + name] = b
    for name, m in (d.get("_modules") or {}).items():
        if m is not None:
            sd.update(_module_state_dict(m, prefix + name + ".", ancestors))
    return sd


def _looks_like_module(obj) -> bool:
    d = getattr(obj, "__dict__", None)
    return isinstance(d, dict) and (
        "_modules" in d or "_parameters" in d or "_buffers" in d)


def read_pt_state_dict(path: str) -> Dict[str, np.ndarray]:
    """``.pt`` -> flat {torch key: numpy array} state dict.

    The engine's load rule (``attempt_load_one_weight``): the ``ema`` entry
    first, then ``model``, then the payload itself as a module or a plain
    state dict. Floats come back as float32 (the engine calls ``.float()``
    on its half-saved weights)."""
    obj = read_pt(path)
    cand = obj
    if isinstance(obj, dict):
        cand = obj.get("ema") or obj.get("model") \
            or obj.get("state_dict") or obj
    if _looks_like_module(cand):
        sd = _module_state_dict(cand)
    elif isinstance(cand, dict):
        sd = cand
    else:
        raise ValueError(f"{path}: cannot locate a module or state dict "
                         f"in the checkpoint (got {type(cand)!r})")
    out: Dict[str, np.ndarray] = {}
    for k, v in sd.items():
        if not isinstance(v, np.ndarray):
            continue  # stubbed non-tensor entries
        if v.dtype.kind == "f" and v.dtype != np.float32:
            v = v.astype(np.float32)
        out[str(k)] = v
    if not out:
        raise ValueError(f"{path}: no tensors found in checkpoint")
    return out
