"""Carry state from the JAX package into the port.

The JAX package's state, given as numpy (the Toeplitz banks with
``pad_left``, the DFT factors, the FSF cubes, the step products
``cube_std``, ``cube_faint``, ``areamap``, ``testO2`` and the thresholds),
becomes the port's tensors: :func:`state_from_numpy` converts it and
:meth:`origin_tpu_torch.pipeline.engine.TorchEngine.load_state` starts a
session from it mid-pipeline.

Steps 08-09 need nothing more: line estimation has no weights and reads
the raw cube, its variance, the PSF and Cat1, which the session already
holds, and step 09 works on the catalogs.  Steps 10-11 have no parameters
either: they read Cat3, the detection cubes, ``segmap_label`` /
``segmap_merged``, the raw cube and the FSF, all held by the session.

Loading a JAX session written in its dense form
(:meth:`origin_tpu_torch.pipeline.session.ORIGIN.load`) is the same
crossing through files, with the same dtypes: float32 cubes, and the
profile index cube in uint8 (up to 255 profiles) or int16.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device

__all__ = ["state_from_numpy"]


def _tensor(a, device):
    a = np.asarray(a)
    if a.dtype.kind == "f":
        a = a.astype(np.float32, copy=False)
    elif a.dtype.kind == "u" and a.dtype.itemsize > 1:
        a = a.astype(np.int64)  # torch has no wide unsigned types
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def state_from_numpy(arrays, device):
    """Tensors on ``device`` for a (nested) dict of numpy state.

    Arrays become tensors (floating point as float32, other dtypes kept,
    wide unsigned integers as int64); dicts, lists and tuples are
    converted element-wise; Python and numpy scalars (``pad_left``,
    thresholds) pass through as Python numbers.
    """
    dev = resolve_device(device)

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(conv(x) for x in v)
        if isinstance(v, np.ndarray):
            return _tensor(v, dev)
        if isinstance(v, np.generic):
            return v.item()
        return v

    return conv(arrays)
