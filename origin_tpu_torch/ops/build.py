"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface.  At first use it is
compiled with ``nvcc`` for ``sm_90a`` into ``build/`` at the repository
root, under a file name keyed by a hash of the source and the flags, and
loaded with ``ctypes``.  A missing ``nvcc`` or a failed build raises and
names the command; nothing falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["load_library", "nvcc_command", "BUILD_INFO"]

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

#: name -> {"command", "seconds", "cached", "ptxas"} of the last load
BUILD_INFO = {}

_LIBS = {}
_LOCK = threading.Lock()


def _find_nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.environ.get("NVCC"),
             os.path.join(home, "bin", "nvcc") if home else None,
             shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    return None


def nvcc_command(name, out=None, nvcc=None):
    """The nvcc command line that builds ``csrc/<name>.cu``."""
    src = CSRC_DIR / f"{name}.cu"
    out = out or BUILD_DIR / f"lib{name}.so"
    return [nvcc or "nvcc", *NVCC_FLAGS, "-o", str(out), str(src)]


def load_library(name):
    """``ctypes.CDLL`` of ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = CSRC_DIR / f"{name}.cu"
        nvcc = _find_nvcc()
        if nvcc is None:
            raise RuntimeError(
                f"nvcc not found (set NVCC or CUDA_HOME): cannot build "
                f"{src} with: {' '.join(nvcc_command(name))}"
            )
        key = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        out = BUILD_DIR / f"lib{name}_{key}.so"
        info = {"cached": out.is_file(), "seconds": 0.0, "ptxas": ""}
        if not info["cached"]:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = BUILD_DIR / f".lib{name}_{key}.{os.getpid()}.so"
            cmd = nvcc_command(name, out=tmp, nvcc=nvcc)
            info["command"] = " ".join(cmd)
            t0 = time.perf_counter()
            res = subprocess.run(cmd, capture_output=True, text=True)
            info["seconds"] = time.perf_counter() - t0
            info["ptxas"] = res.stderr
            if res.returncode != 0:
                raise RuntimeError(
                    f"nvcc build of {src} failed (exit {res.returncode}); "
                    f"command: {' '.join(cmd)}\n{res.stderr}"
                )
            os.replace(tmp, out)  # atomic against concurrent builders
        BUILD_INFO[name] = info
        lib = ctypes.CDLL(str(out))
        _LIBS[name] = lib
        return lib
