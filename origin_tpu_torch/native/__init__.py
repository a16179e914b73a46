"""Native (C++) host-side cores, loaded through ctypes.

The port's copy of ``origin_tpu.native``: the friends-of-friends grouping
of step 07 in C++ (``fof.cpp``), with the same traversal as the Python
DFS in :mod:`origin_tpu_torch.detect.merging`, which stays as the
fallback where no ``g++`` is found.  The library is compiled with ``g++``
on first use into ``build/`` at the repository root (gitignored, beside
the CUDA libraries of :mod:`origin_tpu_torch.ops.build`), never next to
its source.  ``ORIGIN_TPU_NO_NATIVE`` set to anything non-empty skips it.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "fof.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_LIB = None
_TRIED = False


def _build():
    key = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    out = BUILD_DIR / f"libfof_{key.hexdigest()[:16]}.so"
    if not out.is_file():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".{out.name}.{os.getpid()}"
        cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)  # atomic against concurrent builders
    return str(out)


def get_lib():
    """The native library handle, or None when unavailable."""
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        _TRIED = True
        if os.environ.get("ORIGIN_TPU_NO_NATIVE"):
            return None
        try:
            lib = ctypes.CDLL(_build())
            lib.fof_merge_groups.restype = ctypes.c_int
            lib.fof_merge_groups.argtypes = [
                np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
                np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
                ctypes.c_int64,
                ctypes.c_double,
                ctypes.c_double,
                np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ]
            _LIB = lib
        except Exception as exc:  # toolchain-dependent
            logger.warning("native core unavailable (%s); using Python", exc)
    return _LIB


def fof_merge_groups(x, y, z, tol_spat, tol_spec):
    """Native friends-of-friends grouping; returns imatch or None."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    y = np.ascontiguousarray(y, dtype=np.float64)
    z = np.ascontiguousarray(z, dtype=np.float64)
    imatch = np.empty(len(x), dtype=np.int64)
    rc = lib.fof_merge_groups(
        x, y, z, len(x), float(tol_spat), float(tol_spec), imatch
    )
    if rc != 0:
        return None
    return imatch
