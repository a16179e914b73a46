"""3-D local maxima extraction (torch port of :mod:`origin_tpu.ops.localmax`).

The max filter is ``max_pool3d`` with stride 1 over a ``-inf``-padded copy,
the same shrinking-window semantics as ``reduce_window`` with ``-inf``
padding (and as scipy's reflect mode for a max filter).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["local_maxima", "compute_local_max"]


def _maxfilter(x, size):
    pads = []
    for s in reversed(size):  # F.pad lists the last dimension first
        lo = (s - 1) // 2
        pads += [lo, s - 1 - lo]
    xp = F.pad(x[None, None], pads, value=float("-inf"))
    return F.max_pool3d(xp, kernel_size=tuple(size), stride=1)[0, 0]


def local_maxima(x, mask, size=3):
    """Values of x at its local maxima (within a size^3 box), 0 elsewhere."""
    if isinstance(size, int):
        size = (size,) * x.ndim
    filt = _maxfilter(x, size)
    keep = (x == filt) & ~mask
    return torch.where(keep, filt, 0.0)


def compute_local_max(correl, correl_min, mask, size=3):
    """Local maxima of correl and of -correl_min.

    Returns (local_max, local_min): voxel values where the voxel is a box
    maximum (ties keep the value), zero elsewhere and on masked voxels.
    """
    local_max = local_maxima(correl, mask, size)
    local_min = local_maxima(-correl_min, mask, size)
    return local_max, local_min
