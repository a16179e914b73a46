"""Named step products, live in memory.

The part of :mod:`origin_tpu.pipeline.products` that steps 01-11 use: a
per-step name -> value store and the catalog print formats.  Parking
products in a session directory comes with session I/O (see ROADMAP.md).
Cube-sized products stay on the session's device as :class:`TensorCube`,
whose cutouts (:meth:`TensorCube.subcube`) replace the JAX package's
windowed ``DeferredCube`` reads.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.containers import Cube, cutout_wcs, cutout_window
from ..ops.lines import gather_windows

__all__ = ["ProductStore", "TensorCube", "format_catalog"]


def format_catalog(cat):
    """Apply the standard column print formats to a catalog table."""
    for fmt, names in (
        (".1f", ("flux",)),
        (".2f", ("lbda", "T_GLR", "STD")),
        (".3f", ("ra", "dec", "residual", "purity")),
    ):
        for name in names:
            if name in cat.colnames:
                cat.set_format(name, fmt)
    return cat


class TensorCube:
    """A cube product that lives on the session's device.

    ``tensor`` is the (Nz, Ny, Nx) torch tensor; ``data`` copies it to a
    host numpy array on first access (diagnostics, tests).
    """

    def __init__(self, tensor, wcs=None, wave=None):
        self.tensor = tensor
        self.wcs = wcs
        self.wave = wave
        self._host = None

    @property
    def shape(self):
        return tuple(self.tensor.shape)

    @property
    def data(self):
        if self._host is None:
            self._host = self.tensor.cpu().numpy()
        return self._host

    def subcube(self, center, size, unit_center=None):
        """The host ``Cube`` of one (Nz, size, size) window of the tensor.

        ``Cube.subcube``'s semantics (``center`` in pixels, or (dec, ra)
        in degrees with ``unit_center``; the window of
        :func:`~origin_tpu_torch.core.containers.cutout_window`): pixels
        outside the field are data 0 and mask True, non-finite values are
        masked.  One index gather on the device; only the window comes to
        the host.
        """
        if unit_center is not None:
            (y, x), = self.wcs.sky2pix([center])
        else:
            y, x = center
        size = int(size)
        y0, x0 = cutout_window(y, x, size)
        ctr = torch.tensor([[y0 + size // 2], [x0 + size // 2]],
                           device=self.tensor.device)
        data = gather_windows(self.tensor, ctr[0], ctr[1], size,
                              0.0)[0].cpu().numpy()
        ny, nx = self.shape[1:]
        iy, ix = np.arange(y0, y0 + size), np.arange(x0, x0 + size)
        inside = (((iy >= 0) & (iy < ny))[:, None]
                  & ((ix >= 0) & (ix < nx))[None, :])
        out = Cube(data=data, mask=~inside[None] | ~np.isfinite(data),
                   wcs=cutout_wcs(self.wcs, y0, x0, size), wave=self.wave,
                   copy=False)
        out.wave = out._copy_wave()
        return out

    def __repr__(self):
        return (f"<TensorCube {self.shape} {self.tensor.dtype} on "
                f"{self.tensor.device}>")


class ProductStore:
    """Name -> value mapping for one step's declared products."""

    def __init__(self, spec):
        self.spec = dict(spec)
        self._slots = {}

    def __contains__(self, name):
        return name in self.spec

    def names(self):
        return self.spec.keys()

    def peek(self, name):
        return self._slots.get(name)

    def stash(self, name, value):
        if name not in self.spec:
            raise KeyError(f"{name} is not a declared product")
        self._slots[name] = value
