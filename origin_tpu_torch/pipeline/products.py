"""Typed registry for on-disk step products.

Port of :mod:`origin_tpu.pipeline.products`.  A product is in one of three
states:

* **live**: the in-memory object, just computed;
* **parked**: written to the session directory and replaced by a
  :class:`Parked` marker, so its memory is freed; the file is re-read the
  next time the product is fetched;
* **absent**: never produced (fetch returns ``None``).

Cube-sized products live on the session's device as :class:`TensorCube`,
whose cutouts (:meth:`TensorCube.subcube`) replace the JAX package's
windowed ``DeferredCube`` reads.  A ``TensorCube`` parks in its product's
form, as the JAX package writes it by default: a recipe file
(:mod:`.recipes`) when its step left the generators, a scaled-int16 image
(the two correlation cubes) or a sparse scaled-int16 table (the four
local-extrema cubes), quantized on the device (:mod:`..ops.quant`), and a
dense file otherwise.  ``ORIGIN_TPU_STORE_RECIPES=0``,
``ORIGIN_TPU_STORE_INT16=0``, ``ORIGIN_TPU_STORE_SPARSE=0`` and
``ORIGIN_TPU_CORREL_WIRE=f32`` turn the forms off as in the JAX package.
The owning step's ``resolve`` reads a recipe file and its ``upload`` puts a
fetched cube back on the session's device.  The JAX package's background
parking and lane accounting are TPU-link machinery and are not ported.
"""

from __future__ import annotations

import os
from functools import partial
from typing import Callable, NamedTuple

import numpy as np
import torch

from .. import fitsio
from ..core.containers import (
    Cube, Image, _store_int16, _store_sparse, cutout_wcs, cutout_window,
    data_header, write_int16, write_sparse,
)
from ..core.table import Table
from ..ops.lines import gather_windows
from ..ops.quant import encode_i16, sparse_i16
from ..parallel.mesh import RowShards, windowed
from .recipes import recipes_enabled
from .spectra_io import load_spectra, save_spectra

__all__ = ["FORMATS", "Format", "Parked", "ProductStore", "TensorCube",
           "format_catalog", "stored_form"]


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


def stored_form(form):
    """The form a cube of declared ``form`` (``"int16"``, ``"sparse"`` or
    None) is written in under the environment's knobs, as the JAX package
    decides it: ``ORIGIN_TPU_STORE_INT16=0`` leaves both int16 forms
    (the sparse one carries int16 values), ``ORIGIN_TPU_CORREL_WIRE=f32``
    the correlation cubes' int16 form, and ``ORIGIN_TPU_STORE_SPARSE=0``
    stores the extrema as dense int16."""
    if form is None or not _store_int16():
        return None
    if form == "int16" and os.environ.get(
            "ORIGIN_TPU_CORREL_WIRE", "int16").lower() in (
            "f32", "fp32", "float32"):
        return None
    if form == "sparse" and not _store_sparse():
        return "int16"
    return form


class TensorCube:
    """A cube product that lives on the session's device.

    ``tensor`` is the (Nz, Ny, Nx) torch tensor, or on a mesh session its
    :class:`~origin_tpu_torch.parallel.mesh.RowShards`; ``data`` copies it
    to a host numpy array on first access (diagnostics, tests).  ``form``
    is the compact form it is written in (see :func:`stored_form`),
    ``recipe`` the writer of its recipe file, and ``scale`` the scale of
    the compact file it was read from: an unmodified fetch is written
    again as the file's own integers.  Assigning ``tensor`` or ``data``
    replaces the content, which is then written dense, as the JAX package
    writes replaced content.
    """

    def __init__(self, tensor, wcs=None, wave=None, form=None, recipe=None,
                 scale=None, recipe_source=None):
        self._tensor = tensor
        self.wcs = wcs
        self.wave = wave
        self.form = form
        self.recipe = recipe
        self.scale = scale
        # the recipe file this content was rebuilt from (_recipe_current)
        self._recipe_source = recipe_source
        self._host = None
        self._gen = 0
        # True once to_host moved the content off the session's device
        self.offloaded = False

    @property
    def tensor(self):
        return self._tensor

    @tensor.setter
    def tensor(self, value):
        self._tensor = value
        self._host = None
        self.form = self.recipe = self.scale = self._recipe_source = None
        # content generation: ProductStore.park_dirty rewrites it
        self._gen += 1

    @property
    def shape(self):
        return tuple(self._tensor.shape)

    def to_host(self):
        """Move the content to host memory and free its device copy (a
        tight-memory session's eager offload).  Form, recipe and scale
        stay, so the product is written as it would have been; a device
        step gets it back through ``TorchEngine.get``."""
        self._tensor = self._tensor.cpu()
        self._host = None
        self.offloaded = True

    @property
    def data(self):
        if self._host is None:
            self._host = self._tensor.cpu().numpy()
        return self._host

    @data.setter
    def data(self, value):
        value = torch.as_tensor(np.asarray(value))
        if isinstance(self._tensor, RowShards):
            self.tensor = RowShards.split(value, self._tensor.devices)
        else:
            self.tensor = value.to(self._tensor.device)

    def write(self, filename):
        """Write the cube in its form (no recipe: see ``_save_cube``); a
        compact form is quantized on the device, so only int16 values or
        the nonzero entries' pairs come to the host."""
        form = stored_form(self.form)
        dhdr = data_header(self.shape, self.wcs, self.wave)
        t = self._tensor
        # row shards encode their tiles as the whole cube's bits
        sparse, encode = ((t.sparse_i16, t.encode_i16)
                          if isinstance(t, RowShards)
                          else (partial(sparse_i16, t),
                                partial(encode_i16, t)))
        if form == "sparse":
            idx, q, scale = sparse(self.scale)
            write_sparse(filename, idx.cpu().numpy(), q.cpu().numpy(), scale,
                         self.shape, fitsio.Header(), dhdr)
        elif form == "int16":
            q, scale = encode(self.scale)
            write_int16(filename, q.cpu().numpy(), scale, fitsio.Header(),
                        dhdr)
        else:
            self.to_cube().write(filename)

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
        h = size // 2
        data = windowed(
            lambda c, ys, xs: gather_windows(c, ys + h, xs, size, 0.0),
            self._tensor, torch.tensor([y0], device=self._tensor.device),
            size, torch.tensor([x0 + h], device=self._tensor.device),
        )[0].cpu().numpy()
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
                else self._tensor.cpu().numpy())
        return Cube(data=data, mask=False, wcs=self.wcs, wave=self.wave,
                    copy=False)

    def __repr__(self):
        return (f"<TensorCube {self.shape} {self._tensor.dtype} on "
                f"{self._tensor.device}>")


def _save_cube(obj, path):
    """Park a cube product: its recipe file when it has one and recipes
    are on, else the cube in its form."""
    recipe = getattr(obj, "recipe", None)
    if recipe is not None and recipes_enabled():
        recipe(path)
    else:
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
        # reader of a recipe-form cube file (recipes.py) against the
        # owning session's raw data; returns None for any other file
        self.resolve = None
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
            value = self._read(name, value.path)
            if self.spec[name] == "cube" and self.upload is not None:
                value = self.upload(value)
            self._slots[name] = value
            # freshly read == file content; data setters bump _gen, so
            # park_dirty can tell replaced content from a plain re-read
            self._clean[name] = (id(value), getattr(value, "_gen", None))
        return value

    def _read(self, name, path):
        """The host object of a session file (a recipe through
        ``resolve``)."""
        kind = self.spec[name]
        loaded = None
        if kind == "cube" and self.resolve is not None:
            loaded = self.resolve(path)
        return FORMATS[kind].load(path) if loaded is None else loaded

    @staticmethod
    def _recipe_current(value, path):
        """True when ``value`` was rebuilt from the recipe file at ``path``
        (a resumed fetch): re-parking it would serialize the dense cube
        over its own still-valid generator file."""
        return (getattr(value, "_recipe_source", None) == path
                and os.path.isfile(path))

    def _park(self, name, directory):
        path = self.file_for(name, directory)
        value = self._slots[name]
        if not self._recipe_current(value, path):
            FORMATS[self.spec[name]].save(value, path)
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
        into memory (a cube as its host ``Cube``, a recipe as its lazy
        rebuild), so that a write into an erased folder writes them all
        again, each in its form."""
        for name, value in self._slots.items():
            if isinstance(value, Parked) and os.path.isfile(value.path):
                self._slots[name] = self._read(name, value.path)
        self._clean.clear()

    def release(self, directory):
        """Free the live device cubes: one unchanged since it was read
        from its session file in ``directory`` is parked there again; any
        other (never written, as an abandoned field's) loses its content
        and reads as absent."""
        for name, value in self._slots.items():
            if isinstance(value, TensorCube):
                clean = self._clean.pop(name, None) == (id(value),
                                                       value._gen)
                self._slots[name] = (Parked(self.file_for(name, directory))
                                     if clean else None)

    def point_at(self, directory):
        """Mark every product as parked in ``directory`` (used on session
        restore; nothing is read until fetched)."""
        for name in self.spec:
            self._slots[name] = Parked(self.file_for(name, directory))
