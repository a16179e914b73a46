"""Recipe-form checkpointing for exactly-reconstructible cube products.

The port's copy of ``origin_tpu/pipeline/recipes.py``, so that both packages
read and write the same recipe files.  Three of the session's cube-sized
products are pure functions of data the checkpoint already stores:

* ``cube_std`` / ``cont_dct`` — determined by the raw cube (whose path is
  session state) plus the step-01 DCT basis coefficients and per-channel
  background means (~(order+1)/Nz of a cube);
* ``cube_faint`` — ``cube_std`` minus the greedy PCA's recorded rank-1
  factors (a few MB).

The session stores the *generators*: a tiny FITS "recipe" file under the
product's usual name, self-describing via the ``ORITPURE`` primary-header
keyword.  Loading a recipe re-derives the dense cube on the host with the
JAX package's numpy arithmetic, so a recipe file loads bit for bit as it
loads there; the session then puts the rebuilt cube on its device at its
first fetch.  ``ORIGIN_TPU_STORE_RECIPES=0`` restores dense float32 files.

Recipe files are ordinary FITS: a header-only primary HDU plus named
image extensions, readable by any FITS library (the arrays are just the
coefficients rather than the cube).
"""

from __future__ import annotations

import os
import threading
from typing import NamedTuple

import numpy as np

from .. import fitsio
from ..core.containers import Cube, int_window
from ..ops.dct import dctmat

__all__ = [
    "RECIPE_KEY",
    "recipes_enabled",
    "is_recipe_file",
    "write_dct_recipe",
    "write_pca_recipe",
    "recipe_writer",
    "RecipeWriter",
    "rebuild_std_cont",
    "rebuild_std_cont_region",
    "apply_pca_factors",
    "subtract_factors_region",
    "LazyRecipeCube",
    "load_recipe",
    "load_cube",
    "clear_rebuild_contexts",
]

RECIPE_KEY = "ORITPURE"


def recipes_enabled():
    """Store recipe files for the rebuildable cubes (default on)."""
    return os.environ.get("ORIGIN_TPU_STORE_RECIPES", "1") != "0"


def is_recipe_file(path):
    """The recipe kind stored at ``path``, or None for a dense file."""
    try:
        hdr = fitsio.getheader(path, 0)
    except OSError:
        return None
    return hdr.get(RECIPE_KEY)


def _primary(kind, cubename):
    hdr = fitsio.Header()
    hdr[RECIPE_KEY] = kind, "origin_tpu product recipe"
    if cubename:
        hdr["RECUBE"] = str(cubename), "raw cube the recipe rebuilds from"
    return hdr


def write_dct_recipe(path, which, coef, mean_z, order, cubename):
    """Store the cube_std / cont_dct generator: DCT coefficients + means.

    ``which`` is ``"std"`` or ``"cont"``; both recipes carry the same
    payload (the products differ only in which rebuilt array they keep).
    """
    phdr = _primary("dct_std" if which == "std" else "dct_cont", cubename)
    phdr["REORDER"] = int(order), "DCT continuum order"
    chdr = fitsio.Header()
    chdr["EXTNAME"] = "COEF"
    mhdr = fitsio.Header()
    mhdr["EXTNAME"] = "MEANZ"
    fitsio.write(path, [
        fitsio.HDU(header=phdr),
        fitsio.HDU(data=np.asarray(coef, np.float32), header=chdr),
        fitsio.HDU(data=np.asarray(mean_z, np.float32), header=mhdr),
    ])


def write_pca_recipe(path, factors, cubename):
    """Store the cube_faint generator: the greedy PCA's rank-1 factors.

    ``factors`` is step 04's list of ``(idx, u_mat, c_mat)`` per-area
    records; the rebuild subtracts ``u_mat @ c_mat`` from ``cube_std``
    (read recipe-aware from the same session directory) at the flat
    spatial indices ``idx``.
    """
    phdr = _primary("pca_faint", cubename)
    phdr["RENFACT"] = len(factors), "number of per-area factor groups"
    hdus = [fitsio.HDU(header=phdr)]
    for i, (idx, u_mat, c_mat) in enumerate(factors):
        for tag, arr, dt in (("IDX", idx, np.int64), ("U", u_mat, np.float32),
                             ("C", c_mat, np.float32)):
            hdr = fitsio.Header()
            hdr["EXTNAME"] = f"{tag}{i}"
            hdus.append(fitsio.HDU(data=np.asarray(arr, dt), header=hdr))
    fitsio.write(path, hdus)


class RecipeWriter(NamedTuple):
    """The writer ``write(path)`` of a recipe file of ``kind`` (the
    ``RECIPE_KEY`` value) with ``payload``: ``(coef, mean_z, order)`` for
    the DCT kinds, the factor list for ``pca_faint``.  Its fields also
    build the product's host rebuild (:meth:`lazy_cube`)."""

    kind: str
    payload: object
    cubename: object

    def __call__(self, path):
        if self.kind == "pca_faint":
            write_pca_recipe(path, self.payload, self.cubename)
        else:
            coef, mean_z, order = self.payload
            which = "std" if self.kind == "dct_std" else "cont"
            write_dct_recipe(path, which, coef, mean_z, order, self.cubename)

    def lazy_cube(self, orig):
        """The :class:`LazyRecipeCube` of this recipe against the session
        ``orig``'s raw data (a ``pca_faint`` one on its ``cube_std``):
        the product's host form, rebuilt at its first read."""
        std = orig.cube_std if self.kind == "pca_faint" else None
        return LazyRecipeCube(None, self.kind, self.payload, std,
                              _RawContext(orig, self.cubename))


def recipe_writer(kind, payload, cubename):
    """The :class:`RecipeWriter` of a recipe file of ``kind``."""
    if kind not in ("dct_std", "dct_cont", "pca_faint"):
        raise ValueError(f"unknown recipe kind {kind!r}")
    return RecipeWriter(kind, payload, cubename)


def _standardize(raw, var, mask, cont, mean_z):
    """The shared tail of every std/cont rebuild: standardize ``raw``
    against the continuum ``cont`` and turn ``cont`` into cont_dct
    (in place).  Purely elementwise, so full-cube and windowed rebuilds
    running through it agree bit-for-bit on the overlapping voxels."""
    sigma = np.sqrt(var)
    data = raw - cont
    data -= np.asarray(mean_z, np.float32)[:, None, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        data /= sigma
    bad = np.asarray(mask) | ~np.isfinite(data)
    data[bad] = 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        cont /= sigma  # in place: cont becomes cont_dct
    cont[~np.isfinite(cont)] = 0.0
    return data, cont


def rebuild_std_cont(raw, var, mask, coef, mean_z, order):
    """Re-derive (cube_std, cont_dct) from the DCT recipe payload.

    The arithmetic and its order are the JAX package's (numpy on the host),
    so a recipe rebuilds here bit for bit as it rebuilds there; against the
    live device arrays it agrees to float32 summation order.
    """
    nz = raw.shape[0]
    d0 = dctmat(nz, order, dtype=np.float32)
    cont = np.tensordot(d0, np.asarray(coef, np.float32), axes=([1], [0]))
    return _standardize(raw, var, mask, cont, mean_z)


def rebuild_std_cont_region(raw, var, mask, coef, mean_z, zsl, ysl, xsl,
                            d0):
    """Windowed (cube_std, cont_dct) rebuild — only the requested region.

    Every output voxel is an independent length-(order+1) dot plus
    elementwise math, so slicing the INPUTS commutes with the rebuild:
    the window matches the same window of :func:`rebuild_std_cont`
    bit-for-bit for cutout-sized windows (degenerate single-spaxel
    windows can differ by float32 round-off — BLAS selects a different
    micro-kernel for the tiny contraction).  A per-source cutout then costs
    O(window), not O(cube).  ``d0`` is the full (Nz, order+1) DCT basis,
    memoized by the caller across windows.
    """
    coef_w = np.asarray(coef, np.float32)[:, ysl, xsl]
    cont = np.tensordot(d0[zsl], coef_w, axes=([1], [0]))
    return _standardize(
        raw[zsl, ysl, xsl], var[zsl, ysl, xsl],
        np.asarray(mask)[zsl, ysl, xsl], cont,
        np.asarray(mean_z, np.float32)[zsl],
    )


def apply_pca_factors(std, factors):
    """``cube_faint`` from a (copy of) cube_std and the rank-1 factors."""
    faint = np.array(std, dtype=np.float32)
    flat = faint.reshape(faint.shape[0], -1)
    for idx, u_mat, c_mat in factors:
        flat[:, idx] -= u_mat @ c_mat
    return faint


def subtract_factors_region(faint_w, factors, nx, zsl, y0, y1, x0, x1):
    """In-place windowed factor subtraction: the columns of each rank-1
    factor group that fall inside ``[y0:y1, x0:x1]`` are removed from the
    (already windowed) ``faint_w``.  Per-voxel arithmetic matches
    :func:`apply_pca_factors`, so the result is bit-equal to slicing the
    full rebuild.  ``nx`` is the FULL field's x extent (the factor
    indices are flat spatial positions)."""
    flat = faint_w.reshape(faint_w.shape[0], -1)
    for idx, u_mat, c_mat in factors:
        iy, ix = np.divmod(np.asarray(idx), nx)
        inside = (iy >= y0) & (iy < y1) & (ix >= x0) & (ix < x1)
        if not inside.any():
            continue
        (cols,) = np.nonzero(inside)
        wflat = (iy[cols] - y0) * (x1 - x0) + (ix[cols] - x0)
        flat[:, wflat] -= u_mat[zsl] @ c_mat[:, cols]
    return faint_w


def _read_dct_payload(hdus):
    coef = mean_z = None
    for h in hdus:
        if h.name == "COEF":
            coef = np.asarray(h.data, np.float32)
        elif h.name == "MEANZ":
            mean_z = np.asarray(h.data, np.float32)
    if coef is None or mean_z is None:
        raise OSError("malformed DCT recipe: missing COEF/MEANZ")
    return coef, mean_z


def _read_pca_payload(hdus, nfact):
    by_name = {h.name: h for h in hdus}
    factors = []
    for i in range(nfact):
        try:
            idx = np.asarray(by_name[f"IDX{i}"].data, np.int64)
            u_mat = np.asarray(by_name[f"U{i}"].data, np.float32)
            c_mat = np.asarray(by_name[f"C{i}"].data, np.float32)
        except KeyError as exc:
            raise OSError(f"malformed PCA recipe: missing {exc}") from exc
        factors.append((idx, u_mat, c_mat))
    return factors


class _RawContext:
    """Raw-data views for a rebuild: a session when available, else the
    cube file named in the recipe (same fill semantics as the session's
    ``cube_raw`` / ``var`` / ``mask`` properties).

    Sessionless contexts cache their views: N windowed rebuilds against
    the same context (per-source cutouts in ``update_sources`` re-runs)
    read and fill the raw cube once, not once per access."""

    def __init__(self, orig=None, cubename=None):
        import threading

        self.orig = orig
        self.cubename = cubename
        self._views = None
        self._lock = threading.Lock()

    def views(self):
        if self.orig is not None:
            o = self.orig
            return o.cube_raw, o.var, o.mask, o.wcs, o.wave
        with self._lock:
            if self._views is None:
                if not self.cubename or not os.path.isfile(self.cubename):
                    raise OSError(
                        f"recipe rebuild needs the raw cube "
                        f"({self.cubename!r} not found) — pass the session "
                        "or fix the path"
                    )
                cube = Cube(self.cubename)
                raw = cube.filled(0).astype(np.float32)
                var = cube.var_filled(np.inf)
                var = (np.ones(cube.shape, np.float32) if var is None
                       else var.astype(np.float32))
                mask = cube.masked_invalid()
                self._views = (raw, var, mask, cube.wcs, cube.wave)
            return self._views


from collections import OrderedDict as _OrderedDict

_CTX_CACHE = _OrderedDict()
_CTX_CACHE_MAX = 2
_CTX_CACHE_LOCK = threading.Lock()


def clear_rebuild_contexts():
    """Release the sessionless rebuild contexts (and the filled raw-cube
    views they carry — several GB per full MUSE field).

    A batch job calls this when its per-source loop finishes, so a
    long-lived process does not keep the raw views pinned after the last
    consumer is gone.  The next sessionless lazy load simply re-reads the
    cube."""
    with _CTX_CACHE_LOCK:
        _CTX_CACHE.clear()


def _shared_context(cubename):
    """Sessionless rebuild contexts, shared per raw-cube file.

    ``create_source`` re-runs build one
    :class:`LazyRecipeCube` per source; without sharing, each would read
    and fill the full raw cube for its one 25x25 window.  Keyed on
    (realpath, mtime, size) so a rewritten cube is re-read; bounded to
    the two most recent cubes so a survey over many fields cannot pin
    every raw cube in host RAM (and releasable early via
    :func:`clear_rebuild_contexts`)."""
    if not cubename:
        return _RawContext(None, cubename)
    try:
        st = os.stat(cubename)
    except OSError:
        # missing file: the error surfaces on first use, as before
        return _RawContext(None, cubename)
    key = (os.path.realpath(cubename), st.st_mtime_ns, st.st_size)
    with _CTX_CACHE_LOCK:
        ctx = _CTX_CACHE.get(key)
        if ctx is None:
            ctx = _RawContext(None, cubename)
            _CTX_CACHE[key] = ctx
            while len(_CTX_CACHE) > _CTX_CACHE_MAX:
                _CTX_CACHE.popitem(last=False)
        else:
            _CTX_CACHE.move_to_end(key)
        return ctx


class LazyRecipeCube(Cube):
    """A recipe-file cube product that materializes on demand.

    Window reads (per-source cutouts, mask generation, catalog-editing
    re-runs) rebuild only the requested region — O(window) host work —
    while a full ``.data`` access computes and caches the dense cube.
    Resumed sessions and per-source re-runs then never pay a full-field
    rebuild for a handful of 25x25 cutouts.  :attr:`recipe` writes the
    same recipe file again while the content is the recipe's.
    """

    def __init__(self, path, kind, payload, std_source, ctx):
        self.filename = path
        self.primary_header = fitsio.Header()
        self.data_header = fitsio.Header()
        self.var = None
        self.mask = None
        self._data_arr = None
        self._kind = kind
        self._payload = payload  # (coef, mean_z, order) | factors
        self._std_source = std_source  # pca_faint: the cube_std provider
        self._ctx = ctx
        self._rc_lock = threading.Lock()
        self._gen = 0  # bumped by the data setter; guards window reads
        self._d0 = None
        self._views_cache = None
        # shape comes from the payload (dct: the coefficient planes and
        # channel means span the cube) or the cube_std provider (pca) —
        # the raw cube is NOT read here: a pca_faint rebuild never needs
        # it, and for dct kinds a sessionless read is deferred to the
        # first rebuild, so metadata access stays O(recipe file)
        if kind == "pca_faint":
            self._shape = tuple(std_source.shape)
        else:
            coef, mean_z, _ = payload
            self._shape = (int(np.shape(mean_z)[0]),
                           int(np.shape(coef)[-2]), int(np.shape(coef)[-1]))
        self._wcs = self._wave = None
        self._have_coords = False
        if ctx.orig is not None:
            self._wcs, self._wave = ctx.orig.wcs, ctx.orig.wave
            self._have_coords = True
            self._sync_coord_shapes()

    @property
    def recipe(self):
        """Writer of this cube's recipe file, or None once data was
        assigned (the recipe then no longer describes the content)."""
        if self._gen:
            return None
        return recipe_writer(self._kind, self._payload, self._ctx.cubename)

    def _load_coords(self):
        if self._kind == "pca_faint":
            # the cube_std provider carries the same grid (it may itself
            # be lazy; its own coords load then)
            self._wcs = self._std_source.wcs
            self._wave = self._std_source.wave
        else:
            self._raw_views()  # sets coords from the raw cube
        self._have_coords = True
        self._sync_coord_shapes()

    @property
    def wcs(self):
        if self._wcs is None and not self._have_coords:
            self._load_coords()
        return self._wcs

    @wcs.setter
    def wcs(self, value):
        self._wcs = value

    @property
    def wave(self):
        if self._wave is None and not self._have_coords:
            self._load_coords()
        return self._wave

    @wave.setter
    def wave(self, value):
        self._wave = value

    def _raw_views(self):
        """(raw, var, mask) for the dct rebuilds, read/filled once."""
        if self._views_cache is None:
            raw, var, mask, wcs, wave = self._ctx.views()
            self._views_cache = (raw, var, mask)
            if not self._have_coords:
                self._wcs, self._wave = wcs, wave
                self._have_coords = True
        return self._views_cache

    @property
    def shape(self):
        return self._shape if self._data_arr is None else \
            self._data_arr.shape

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def dtype(self):
        return np.dtype(np.float32) if self._data_arr is None else \
            self._data_arr.dtype

    def _rebuild_full(self):
        if self._kind in ("dct_std", "dct_cont"):
            raw, var, mask = self._raw_views()
            coef, mean_z, order = self._payload
            std, cont = rebuild_std_cont(raw, var, mask, coef, mean_z,
                                         order)
            return std if self._kind == "dct_std" else cont
        return apply_pca_factors(self._std_source.data, self._payload)

    def _rebuild_region(self, zsl, ysl, xsl):
        if self._kind in ("dct_std", "dct_cont"):
            raw, var, mask = self._raw_views()
            coef, mean_z, order = self._payload
            if self._d0 is None:
                self._d0 = dctmat(raw.shape[0], order, dtype=np.float32)
            std_w, cont_w = rebuild_std_cont_region(
                raw, var, mask, coef, mean_z, zsl, ysl, xsl, self._d0)
            return std_w if self._kind == "dct_std" else cont_w
        faint = np.array(self._std_source._region(zsl, ysl, xsl)[0],
                         dtype=np.float32)
        nx = self._shape[2]
        return subtract_factors_region(
            faint, self._payload, nx, zsl,
            *ysl.indices(self._shape[1])[:2],
            *xsl.indices(nx)[:2],
        )

    @property
    def data(self):
        with self._rc_lock:
            if self._data_arr is None:
                self._data_arr = self._rebuild_full()
            return self._data_arr

    @data.setter
    def data(self, val):
        with self._rc_lock:
            self._data_arr = np.asarray(val)
            self._gen += 1
            # the recipe file no longer describes this content: a
            # session write() must park it densely instead of skipping
            # the save (products._recipe_current)
            self._recipe_source = None

    def _region(self, zsl, ysl, xsl):
        with self._rc_lock:
            arr, gen = self._data_arr, self._gen
        if arr is not None:
            return arr[zsl, ysl, xsl], None, None
        if any(isinstance(sl, slice) and sl.step not in (None, 1)
               for sl in (zsl, ysl, xsl)):
            return super()._region(zsl, ysl, xsl)  # rare: full rebuild
        orig_idx = (zsl, ysl, xsl)
        nz, ny, nx = self._shape
        squeeze_z = not isinstance(zsl, slice)
        if squeeze_z:
            zsl = int_window(zsl, nz)
        squeeze_y = not isinstance(ysl, slice)
        if squeeze_y:
            ysl = int_window(ysl, ny)
        squeeze_x = not isinstance(xsl, slice)
        if squeeze_x:
            xsl = int_window(xsl, nx)
        block = self._rebuild_region(slice(*zsl.indices(nz)[:2]),
                                     slice(*ysl.indices(ny)[:2]),
                                     slice(*xsl.indices(nx)[:2]))
        with self._rc_lock:
            if self._gen != gen:
                # content replaced while the window rebuilt: serve the
                # now-current dense data instead of the stale recipe
                return (self._data_arr[orig_idx[0], orig_idx[1],
                                       orig_idx[2]], None, None)
        if squeeze_x:
            block = block[..., 0]
        if squeeze_y:
            block = block[:, 0] if block.ndim > 1 else block
        if squeeze_z:
            block = block[0]
        return block, None, None


def load_recipe(path, orig=None, lazy=False):
    """Materialize the dense Cube a recipe file stands for.

    ``orig`` (an ORIGIN session) provides the raw-data views without
    re-reading the cube file; without it the recipe's recorded cube path
    is read from disk.  ``pca_faint`` recipes resolve ``cube_std`` from
    the same directory (recipe-aware, so either storage mode works) —
    or from the live session when one is given.  With ``lazy=True`` the
    dense rebuild is deferred: window reads rebuild O(window)
    (:class:`LazyRecipeCube`), a full ``.data`` access rebuilds once.
    """
    hdus = fitsio.read(path)
    phdr = hdus[0].header
    kind = phdr.get(RECIPE_KEY)
    cubename = phdr.get("RECUBE")
    ctx = (_RawContext(orig, cubename) if orig is not None
           else _shared_context(cubename))
    if kind in ("dct_std", "dct_cont"):
        coef, mean_z = _read_dct_payload(hdus)
        order = int(phdr["REORDER"])
        if lazy:
            return LazyRecipeCube(path, kind, (coef, mean_z, order),
                                  None, ctx)
        raw, var, mask, wcs, wave = ctx.views()
        std, cont = rebuild_std_cont(raw, var, mask, coef, mean_z, order)
        data = std if kind == "dct_std" else cont
        return Cube(data=data, wcs=wcs, wave=wave, mask=False, copy=False)
    if kind == "pca_faint":
        factors = _read_pca_payload(hdus, int(phdr.get("RENFACT", 0)))
        # fetch from the session (recipe-aware via the store) when it
        # still holds the product; a session whose cube_std file was
        # deleted falls back to the recipe's own directory like the
        # session-less path
        std_cube = orig.cube_std if orig is not None else None
        if std_cube is None:
            std_path = os.path.join(os.path.dirname(path), "cube_std.fits")
            if not os.path.isfile(std_path):
                raise OSError(
                    f"pca_faint recipe rebuild needs cube_std ({std_path!r}"
                    " not found in the session directory)"
                )
            std_cube = load_cube(std_path, orig=orig, lazy=lazy)
        if lazy:
            return LazyRecipeCube(path, kind, factors, std_cube, ctx)
        std = std_cube.data
        if orig is not None:
            wcs, wave = orig.wcs, orig.wave
        else:
            wcs, wave = std_cube.wcs, std_cube.wave
        return Cube(data=apply_pca_factors(std, factors), wcs=wcs,
                    wave=wave, mask=False, copy=False)
    raise OSError(f"unknown recipe kind {kind!r} in {path}")


def load_cube(path, orig=None, lazy=False):
    """Read a session cube product, dense or recipe-form."""
    if is_recipe_file(path):
        return load_recipe(path, orig=orig, lazy=lazy)
    return Cube(path)
