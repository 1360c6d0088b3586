"""Build a shared library from sources at first use and load it.

The library lands in the package's ``_build/`` directory under a name that
carries a hash of its sources and command, so an edited source never serves
a stale binary. The compiler writes to a temporary name that is renamed into
place, so a concurrent process never opens a half-written file; no lock is
taken, so nothing can wait forever on one left behind.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "_build")


def build_shared_library(name: str, sources: list[str], command: list[str],
                         timeout: float = 300.0) -> ctypes.CDLL:
    """Compile ``sources`` with ``command + ['-o', out] + sources`` into
    ``_build/lib{name}-{hash}.so`` unless it is there already, then load
    it. Raises ``RuntimeError`` with the compiler's output on failure."""
    h = hashlib.sha256(" ".join(command).encode())
    for src in sources:
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
