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

__all__ = ["load_library", "load_libraries", "nvcc_command", "BUILD_INFO",
           "KERNELS"]

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build"

# ptxas fails a kernel that spills registers or uses local memory: the
# sweep kernel's register blocking would be gone.  The flags are part of
# the cache key, so a cached library has passed the same rule.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v,-warn-spills,-warn-lmem-usage,-Werror",
)

#: every CUDA source of the port, by name
KERNELS = ("toeplitz_sweep", "sweep_bf16x3", "spatial_fsf")

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
    return load_libraries([name])[name]


def load_libraries(names):
    """``{name: ctypes.CDLL}`` of ``csrc/<name>.cu`` for each name; the
    ones not built yet are compiled together, one ``nvcc`` per source,
    all started at once."""
    with _LOCK:
        todo = [n for n in dict.fromkeys(names) if n not in _LIBS]
        nvcc = _find_nvcc() if todo else None
        if todo and nvcc is None:
            raise RuntimeError(
                f"nvcc not found (set NVCC or CUDA_HOME): cannot build "
                f"{todo} with: {' '.join(nvcc_command(todo[0]))}"
            )
        jobs = {}
        for name in todo:
            src = CSRC_DIR / f"{name}.cu"
            key = hashlib.sha256(
                src.read_bytes() + " ".join(NVCC_FLAGS).encode()
            ).hexdigest()[:16]
            out = BUILD_DIR / f"lib{name}_{key}.so"
            info = {"cached": out.is_file(), "seconds": 0.0, "ptxas": ""}
            BUILD_INFO[name] = info
            if info["cached"]:
                jobs[name] = (out, None, None, None)
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = BUILD_DIR / f".lib{name}_{key}.{os.getpid()}.so"
            cmd = nvcc_command(name, out=tmp, nvcc=nvcc)
            info["command"] = " ".join(cmd)
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
            jobs[name] = (out, tmp, proc, time.perf_counter())
        failed = []
        for name, (out, tmp, proc, t0) in jobs.items():
            if proc is None:
                continue
            _, err = proc.communicate()
            info = BUILD_INFO[name]
            info["seconds"] = time.perf_counter() - t0
            info["ptxas"] = err
            if proc.returncode != 0:
                failed.append(f"nvcc build of {CSRC_DIR / (name + '.cu')} "
                              f"failed (exit {proc.returncode}); command: "
                              f"{info['command']}\n{err}")
            else:
                os.replace(tmp, out)  # atomic against concurrent builders
        if failed:
            raise RuntimeError("\n".join(failed))
        for name, (out, *_) in jobs.items():
            _LIBS[name] = ctypes.CDLL(str(out))
        return {name: _LIBS[name] for name in names}
