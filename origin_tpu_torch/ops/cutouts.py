"""Batched window reductions for per-source artifacts (steps 10-11).

Torch port of :mod:`origin_tpu.ops.cutouts`.  Step 10 needs, for every
detected line, the max-image of the detection cube over its spectral slab
on a small window centred at the source; step 11 needs, per source, the
object-mean spectrum and the spectral max map of its detection-cube
window.  Both are one index gather of all windows on the cube's device and
one reduction, so only the images and spectra come to the host.

The JAX functions pad the slab and the batch to bucketed sizes to bound
XLA recompiles; torch does not recompile, so the slab here is the batch's
largest ``zhi - zlo + 1`` and the batch is what the caller gives.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["line_max_images", "window_ori_stats"]


def _axis(starts, size, n):
    """Clamped indices and in-range flags of windows ``starts + [0, size)``
    along an axis of length ``n``: (B, size) each."""
    idx = starts[:, None] + torch.arange(size, device=starts.device)
    return idx.clamp(0, n - 1), (idx >= 0) & (idx < n)


def _index(a, device):
    return torch.as_tensor(np.asarray(a, np.int64), device=device)


def window_ori_stats(cube, y0, x0, objm, size):
    """Per-source detection-cube stats: object-mean spectrum + max map.

    For each (size x size) window at (y0, x0) (possibly out of field) of
    the (Nz, Ny, Nx) tensor ``cube``, returns the mean spectrum over the
    object-mask pixels ``objm > 0`` ((B, size, size)) that lie in the
    field, NaN when there are none (the host nanmean convention), and the
    spectral max map, -inf outside the field: (B, Nz) and (B, size, size)
    tensors.  As in ``window_ori_stats_kernel``, the window reads clamped
    indices, so a non-finite value at a clamped position reaches the
    spectrum through its zero weight.
    """
    nz, ny, nx = cube.shape
    dev = cube.device
    ys, vy = _axis(_index(y0, dev), size, ny)
    xs, vx = _axis(_index(x0, dev), size, nx)
    flat = (ys[:, :, None] * nx + xs[:, None, :]).reshape(-1)
    win = cube.reshape(nz, ny * nx)[:, flat]
    win = win.reshape(nz, -1, size, size).transpose(0, 1)
    valid = vy[:, :, None] & vx[:, None, :]
    w = (torch.as_tensor(objm, device=dev) > 0) & valid
    cnt = w.sum(dim=(1, 2))
    spec = torch.einsum("bzyx,byx->bz", win, w.to(cube.dtype)) / cnt[:, None]
    maxmap = torch.amax(torch.where(valid[:, None], win, -torch.inf), dim=1)
    return spec, maxmap


def line_max_images(cube, y0, x0, zlo, zhi, size):
    """Per-line spectral-slab max over spatial windows.

    Parameters
    ----------
    cube : (Nz, Ny, Nx) tensor
    y0, x0 : (B,) int window start indices (may be negative / out of the
        field; pixels outside the field come back as -inf)
    zlo, zhi : (B,) int inclusive spectral range, pre-clamped to
        [0, Nz-1] with zlo <= zhi
    size : window edge length

    Returns (images, valid): (B, size, size) with -inf outside the field
    (NaN where the slab holds one: ``torch.amax`` propagates it, as
    ``jnp.max`` does), and the (B, size, size) in-field mask.
    """
    nz, ny, nx = cube.shape
    dev = cube.device
    zlo, zhi = np.asarray(zlo, np.int64), np.asarray(zhi, np.int64)
    slab = int(np.max(zhi - zlo)) + 1 if zlo.size else 1
    ys, vy = _axis(_index(y0, dev), size, ny)
    xs, vx = _axis(_index(x0, dev), size, nx)
    zs = _index(zlo, dev)[:, None] + torch.arange(slab, device=dev)
    vz = zs <= _index(zhi, dev)[:, None]
    win = cube[zs.clamp(0, nz - 1)[:, :, None, None],
               ys[:, None, :, None], xs[:, None, None, :]]
    win = torch.where(vz[:, :, None, None], win, -torch.inf)
    valid = vy[:, :, None] & vx[:, None, :]
    img = torch.amax(win, dim=1)
    return torch.where(valid, img, -torch.inf), valid
