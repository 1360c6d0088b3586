"""Build a shared library from sources at first use, load it, and call the
kernel launchers it exports.

The library lands in the package's ``_build/`` directory under a name that
carries a hash of its sources and command, so an edited source never serves
a stale binary. The compiler writes to a temporary name that is renamed into
place, so a concurrent process never opens a half-written file; no lock is
taken, so nothing can wait forever on one left behind.

The port's CUDA kernels (``csrc/*.cu``) build with ``nvcc()`` and
``NVCC_FLAGS`` into a library with a plain C interface, bound through
ctypes; ``launch`` calls one of its launchers on a tensor's current stream
(``stream``) and raises on a CUDA error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def build_shared_library(name: str, sources: list[str], command: list[str],
                         timeout: float = 300.0,
                         includes: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile ``sources`` with ``command + ['-o', out] + sources`` into
    ``_build/lib{name}-{hash}.so`` unless it is there already, then load
    it. ``includes`` are files the sources include: hashed with them, not
    compiled. Raises ``RuntimeError`` with the compiler's output on
    failure."""
    h = hashlib.sha256(" ".join(command).encode())
    for src in [*sources, *includes]:
        with open(src, "rb") as f:
            h.update(f.read())
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if not os.path.exists(out):
        tmp = f"{out}.tmp.{os.getpid()}"
        try:
            res = subprocess.run(command + ["-o", tmp] + sources,
                                 capture_output=True, text=True,
                                 timeout=timeout)
            if res.returncode != 0:
                raise RuntimeError(
                    f"building {name} failed ({res.returncode}):\n"
                    f"{' '.join(command)}\n{res.stdout}{res.stderr}")
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return ctypes.CDLL(out)


def nvcc() -> str:
    """The CUDA toolkit's nvcc; raises if there is none."""
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels build "
                           "with the CUDA toolkit's nvcc")
    return path


def stream(t: torch.Tensor) -> int:
    """The handle of ``t``'s device's current stream, for a launcher."""
    return torch.cuda.current_stream(t.device).cuda_stream


def launch(name: str, launcher, *args) -> None:
    """Call the ctypes ``launcher`` of kernel ``name`` with ``args``;
    raise if it returns a CUDA error. While a ``torch.profiler`` collects,
    the call is an operator named ``name`` on its timeline: the profiler
    links a kernel to the operator that launched it, and a launch from
    outside any operator would be linked to none, so its time would fall
    outside the caller's spans."""
    if torch._C._autograd._profiler_enabled():
        with torch._C._profiler._RecordFunctionFast(name):
            err = launcher(*args)
    else:
        err = launcher(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
