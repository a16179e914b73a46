"""Named step products, live in memory.

The part of :mod:`origin_tpu.pipeline.products` that steps 01-09 use: a
per-step name -> value store and the catalog print formats.  Parking
products in a session directory comes with session I/O (see ROADMAP.md).
Cube-sized products stay on the session's device as :class:`TensorCube`.
"""

from __future__ import annotations

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
