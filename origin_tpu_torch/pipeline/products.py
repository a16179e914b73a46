"""Typed registry for on-disk step products.

Port of :mod:`origin_tpu.pipeline.products` in its dense form.  A product
is in one of three states:

* **live**: the in-memory object, just computed;
* **parked**: written to the session directory and replaced by a
  :class:`Parked` marker, so its memory is freed; the file is re-read the
  next time the product is fetched;
* **absent**: never produced (fetch returns ``None``).

Cube-sized products live on the session's device as :class:`TensorCube`,
whose cutouts (:meth:`TensorCube.subcube`) replace the JAX package's
windowed ``DeferredCube`` reads.  A ``TensorCube`` parks as a dense
``Cube`` file of its host copy; the owning step's ``upload`` puts a
fetched cube back on the session's device.  The JAX package's background
parking, lane accounting and recipe files are TPU-link and compact-store
machinery and are not ported.
"""

from __future__ import annotations

import os
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..core.containers import Cube, Image, cutout_wcs, cutout_window
from ..core.table import Table
from ..ops.lines import gather_windows
from .spectra_io import load_spectra, save_spectra

__all__ = ["FORMATS", "Format", "Parked", "ProductStore", "TensorCube",
           "format_catalog"]


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

    def to_cube(self):
        """The host ``Cube`` of the tensor, as the session file stores it
        (no mask: every value is kept).  The host copy is not cached."""
        data = (self._host if self._host is not None
                else self.tensor.cpu().numpy())
        return Cube(data=data, mask=False, wcs=self.wcs, wave=self.wave,
                    copy=False)

    def __repr__(self):
        return (f"<TensorCube {self.shape} {self.tensor.dtype} on "
                f"{self.tensor.device}>")


def _save_cube(obj, path):
    if isinstance(obj, TensorCube):
        obj = obj.to_cube()
    obj.write(path)


class Format(NamedTuple):
    """How one product kind maps to a session file."""

    suffix: str
    load: Callable
    save: Callable


FORMATS = {
    "cube": Format(".fits", Cube, _save_cube),
    "image": Format(".fits", Image, lambda obj, path: obj.write(path)),
    "table": Format(
        ".fits",
        lambda path: format_catalog(Table.read(path)),
        lambda obj, path: obj.write(path, overwrite=True),
    ),
    "array": Format(
        ".txt",
        lambda path: np.loadtxt(path, ndmin=1),
        lambda obj, path: np.savetxt(path, np.atleast_1d(obj)),
    ),
    "spectra": Format(".fits", load_spectra, save_spectra),
}


class Parked:
    """Marker standing in for a product that lives in a session file."""

    __slots__ = ("path",)

    def __init__(self, path):
        self.path = path

    def __repr__(self):
        return f"Parked({self.path!r})"


class ProductStore:
    """Name -> value mapping for one step's typed products.

    ``spec`` maps each product name to a key of :data:`FORMATS`.
    """

    def __init__(self, spec):
        self.spec = dict(spec)
        self._slots = {}
        self._clean = {}  # name -> (id, gen) recorded at fetch time
        # loader of a fetched cube product: the owning step puts the host
        # Cube back on the session's device as a TensorCube
        self.upload = None

    def __contains__(self, name):
        return name in self.spec

    def names(self):
        return self.spec.keys()

    def file_for(self, name, directory):
        return os.path.join(directory, name + FORMATS[self.spec[name]].suffix)

    def peek(self, name):
        """The raw slot value (live object, Parked marker, or None) —
        never touches the disk."""
        return self._slots.get(name)

    def stash(self, name, value):
        if name not in self.spec:
            raise KeyError(f"{name} is not a declared product")
        self._slots[name] = value
        self._clean.pop(name, None)  # a stashed object is new content

    def fetch(self, name):
        """Materialize a product, reading its session file if parked (a
        cube product through ``upload``, when set)."""
        value = self._slots.get(name)
        if isinstance(value, Parked):
            if not os.path.isfile(value.path):
                return None
            kind = self.spec[name]
            value = FORMATS[kind].load(value.path)
            if kind == "cube" and self.upload is not None:
                value = self.upload(value)
            self._slots[name] = value
            # freshly read == file content; data setters bump _gen, so
            # park_dirty can tell replaced content from a plain re-read
            self._clean[name] = (id(value), getattr(value, "_gen", None))
        return value

    def _park(self, name, directory):
        path = self.file_for(name, directory)
        FORMATS[self.spec[name]].save(self._slots[name], path)
        self._slots[name] = Parked(path)
        self._clean.pop(name, None)

    def park_all(self, directory):
        """Write every live product to ``directory`` and free its memory."""
        for name in self.spec:
            value = self._slots.get(name)
            if value is not None and not isinstance(value, Parked):
                self._park(name, directory)

    def park_dirty(self, directory):
        """Write live products whose content was replaced since they were
        read from the session — an object assigned via the data setter,
        or a new object stashed onto an already-dumped step — leaving
        untouched fetches (a cube uploaded at its fetch included) alone.

        In-place mutation of a fetched array remains undetectable, as in
        the reference.
        """
        for name in self.spec:
            value = self._slots.get(name)
            if value is None or isinstance(value, Parked):
                continue
            rec = self._clean.get(name)
            if (rec is not None and rec[0] == id(value)
                    and rec[1] == getattr(value, "_gen", None)):
                continue  # unmodified fetch: the session file is current
            self._park(name, directory)

    def move(self, old, new):
        """Follow a copy of the session folder: products parked in ``old``
        point at their copies in ``new``."""
        for name, value in self._slots.items():
            if (isinstance(value, Parked)
                    and os.path.dirname(value.path) == old):
                self._slots[name] = Parked(self.file_for(name, new))

    def hold_all(self):
        """Mark every product as new content, reading the parked ones back
        into memory (a cube as its host ``Cube``), so that a write into an
        erased folder writes them all again."""
        for name, value in self._slots.items():
            if isinstance(value, Parked) and os.path.isfile(value.path):
                self._slots[name] = FORMATS[self.spec[name]].load(value.path)
        self._clean.clear()

    def point_at(self, directory):
        """Mark every product as parked in ``directory`` (used on session
        restore; nothing is read until fetched)."""
        for name in self.spec:
            self._slots[name] = Parked(self.file_for(name, directory))
