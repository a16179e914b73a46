"""Cube / Image / Spectrum containers.

(The port's copy of the part of ``origin_tpu/core/containers.py`` that steps
01-11 use: float data with optional variance and mask, world coordinates, FITS
reads and writes, the reductions of a session's white image, the trimmed
per-line spectra of step 08 and the cutouts of steps 10-11, and the compact
forms of the JAX package's session files: scaled-int16 images and sparse
scaled-int16 tables.  The JAX package's ``QuantCube``, which cuts int16
windows from a host wire, is not ported: the port cuts its windows on the
device, so every cutout is float32.)

Replaces the subset of ``mpdaf.obj.Cube/Image/Spectrum`` used by the reference
(see reference steps.py:284-299): data + optional variance + optional boolean
mask (True = invalid), world coordinates, and FITS round-trips (DATA/STAT
extensions with NaN-encoded masks).
"""

from __future__ import annotations

import numpy as np

from .. import fitsio
from .coords import WCS, WaveCoord

__all__ = ["Cube", "Image", "Spectrum", "Quant16", "cutout_window",
           "cutout_wcs", "write_int16", "write_sparse"]

# primary-header marker of a sparse scaled-int16 cube file (the session
# storage of the four local-extrema cubes; see _Base.write / _Base._load)
SPARSE_KEY = "ORITPUSP"


def _store_sparse():
    """``ORIGIN_TPU_STORE_SPARSE=0`` stores the local-extrema cubes as
    dense images instead of sparse tables."""
    import os

    return os.environ.get("ORIGIN_TPU_STORE_SPARSE", "1").lower() not in (
        "0", "false")


def _store_int16():
    """``ORIGIN_TPU_STORE_INT16=0`` stores every cube product as float32
    (the sparse form too: its values are the int16 ones)."""
    import os

    return os.environ.get("ORIGIN_TPU_STORE_INT16", "1").lower() not in (
        "0", "false", "f32", "float32")


class Quant16:
    """What a loaded scaled-int16 file keeps of its form: the ``scale``
    (``physical = q * scale``) and, for the sparse form, the ``pairs``
    (flat index, int16 value) of the nonzero entries.

    Detection-statistic cubes are noise-normalized, so the quantization
    floor ``max|x| / 32766`` sits far below their noise; the session
    stores them as BITPIX 16 images with a ``BSCALE`` card, and the
    mostly-zero local-extrema cubes as their pairs.  An image's integers
    are ``round(decoded / scale)``, exactly (``|q| < 2**15``, so
    ``fl(fl(q * s) / s)`` is within 2**-9 of ``q``): the wire keeps no
    int16 copy of them.
    """

    __slots__ = ("scale", "pairs")

    def __init__(self, scale, pairs=None):
        self.scale = float(scale)
        self.pairs = pairs


def requantize(data, scale):
    """The int16 integers of float32 ``data`` at ``scale`` (host numpy:
    ``clip(round_half_even(data / f32(scale)), +-32767)``)."""
    q = np.round(np.asarray(data, np.float32) / np.float32(scale))
    return np.clip(q, -32767, 32767).astype(np.int16)


def data_header(shape, wcs, wave):
    """wcs/wave/EXTNAME header for the DATA extension of an array of
    ``shape``."""
    dhdr = fitsio.Header()
    if wcs is not None:
        wcs.to_header(dhdr)
    if wave is not None and len(shape) in (1, 3):
        wave.to_header(dhdr, axis=3 if len(shape) == 3 else 1)
    dhdr["EXTNAME"] = "DATA"
    return dhdr


def write_int16(filename, q, scale, primary_header, dhdr):
    """A scaled-int16 image file: BITPIX 16 with ``BSCALE = scale``."""
    dhdr = dhdr.copy()
    dhdr["BSCALE"] = float(scale), "physical = BSCALE * stored"
    dhdr["BZERO"] = 0.0
    fitsio.write(filename, [
        fitsio.HDU(header=primary_header.copy()),
        fitsio.HDU(data=np.asarray(q, np.int16), header=dhdr),
    ])


def write_sparse(filename, fidx, qvals, scale, shape, primary_header, dhdr):
    """A sparse scaled-int16 cube file: the ``SPARSE_KEY`` primary card
    with the scale and the shape, and a binary table of the nonzero
    entries' flat indices (``IDX``) and int16 values (``VAL``)."""
    from collections import OrderedDict

    phdr = primary_header.copy()
    for key in (SPARSE_KEY, "SPSCALE", "SPNZ", "SPNY", "SPNX"):
        if key in phdr:  # a loaded sparse file's: written again in order
            del phdr[key]
    phdr[SPARSE_KEY] = ("extrema16", "sparse scaled-int16 cube (origin_tpu)")
    phdr["SPSCALE"] = float(scale), "physical = SPSCALE * VAL"
    nz, ny, nx = shape
    phdr["SPNZ"] = int(nz)
    phdr["SPNY"] = int(ny)
    phdr["SPNX"] = int(nx)
    cols = OrderedDict(IDX=np.asarray(fidx), VAL=np.asarray(qvals, np.int16))
    fitsio.write(filename, [
        fitsio.HDU(header=phdr),
        fitsio.HDU(data=cols, header=dhdr),
    ])


class _Base:
    """Shared implementation: data/var/mask + FITS I/O."""

    _ndim = None

    def __init__(self, filename=None, data=None, var=None, mask=None, wcs=None,
                 wave=None, primary_header=None, copy=True):
        self.filename = filename
        self.primary_header = primary_header or fitsio.Header()
        self.data_header = fitsio.Header()
        self.wcs = wcs
        self.wave = wave
        if filename is not None and data is None:
            self._load(filename)
        else:
            data = np.asarray(data)
            self.data = np.array(data, copy=copy)
            self.var = None if var is None else np.array(var, copy=copy)
            if mask is None:
                m = ~np.isfinite(self.data) if self.data.dtype.kind == "f" else None
                self.mask = m if (m is not None and m.any()) else None
                if self.data.dtype.kind == "f":
                    self._stamp_nonfinite_mask()
            elif mask is False or (np.ndim(mask) == 0 and not mask):
                # False / np.ma.nomask (mpdaf's "no mask" sentinel): the
                # scalar would also trip numpy 2's copy=False strictness
                self.mask = None
            else:
                self.mask = np.array(mask, dtype=bool, copy=copy)
        self._sync_coord_shapes()

    def _sync_coord_shapes(self):
        shape = self.shape
        if self.wcs is not None and self.wcs.shape is None:
            self.wcs.shape = shape[-2:] if len(shape) >= 2 else None
        if self.wave is not None and self.wave.shape is None and len(shape) != 2:
            self.wave.shape = shape[0]

    # -- basic properties ----------------------------------------------------
    @property
    def data(self):
        return self._data_arr

    @data.setter
    def data(self, val):
        self._data_arr = val
        # replaced content: a stamped derived-mask shortcut is stale
        self._mask_is_nonfinite = False
        # ... a kept int16 wire (loaded compact files keep theirs, so a
        # re-park writes the same integers; see _load) is stale too
        self._wire16 = None
        # ... and a recipe-file provenance stamp: the generator file no
        # longer describes this content (products._recipe_current)
        self._recipe_source = None
        # content generation: lets ProductStore.park_dirty distinguish a
        # replaced product from a plain re-read on a resumed session
        self._gen = getattr(self, "_gen", 0) + 1

    @property
    def shape(self):
        return self.data.shape

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def dtype(self):
        return self.data.dtype

    def masked_invalid(self):
        # loaded/streamed cubes derived their mask as EXACTLY the data's
        # non-finite pattern: serve it instead of re-scanning the full
        # array (10+ s per access at full-field scale).  The shortcut is
        # dropped when the data or the mask object was replaced since.
        if getattr(self, "_mask_is_nonfinite", False) and \
                self.mask is getattr(self, "_derived_mask", ()):
            m = self.mask
            return m if m is not None else np.zeros(self.shape, bool)
        m = ~np.isfinite(self.data)
        if self.mask is not None:
            m |= self.mask
        return m

    def _stamp_nonfinite_mask(self):
        """Record that ``self.mask`` IS the data's non-finite pattern
        (or None with all-finite data) — see :meth:`masked_invalid`."""
        self._mask_is_nonfinite = True
        self._derived_mask = self.mask

    def filled(self, fill_value=0.0):
        """Data with masked entries replaced by fill_value."""
        if self.mask is None:
            # stamped loads know mask None means all-finite: skip the
            # full-array scan (seconds at full-field scale)
            if (getattr(self, "_mask_is_nonfinite", False)
                    and self._derived_mask is None) \
                    or np.isfinite(self.data).all():
                return self.data
        out = np.array(self.data, copy=True)
        out[self.masked_invalid()] = fill_value
        return out

    def var_filled(self, fill_value=np.inf):
        if self.var is None:
            return None
        out = np.array(self.var, copy=True)
        bad = ~np.isfinite(out)
        if self.mask is not None:
            bad |= self.mask
        out[bad] = fill_value
        return out

    def _dense_cls(self):
        """Container class for derived results (copy), keyed on
        dimensionality."""
        return {3: Cube, 2: Image, 1: Spectrum}.get(self.ndim, type(self))

    def copy(self):
        new = self._dense_cls()(
            data=self.data, var=self.var, mask=self.mask,
            wcs=self._copy_wcs(), wave=self._copy_wave(), copy=True,
        )
        new.primary_header = self.primary_header.copy()
        return new

    def _copy_wcs(self):
        if self.wcs is None:
            return None
        return WCS(crpix=tuple(self.wcs.crpix), crval=tuple(self.wcs.crval),
                   cd=self.wcs.cd.copy(), shape=self.wcs.shape)

    def _copy_wave(self):
        if self.wave is None:
            return None
        return WaveCoord(crpix=self.wave.crpix, crval=self.wave.crval,
                         cdelt=self.wave.cdelt, ctype=self.wave.ctype,
                         shape=self.wave.shape)

    # -- reductions --------------------------------------------------------------
    def _reduce(self, func, axis):
        import warnings

        data = self.filled(np.nan)
        with np.errstate(invalid="ignore"), warnings.catch_warnings():
            # all-NaN slices (fully masked spaxels) are expected; the
            # resulting NaNs become the output mask below
            warnings.simplefilter("ignore", category=RuntimeWarning)
            out = func(data, axis=axis)
        if np.ndim(out) == 0:
            return float(out)
        mask = ~np.isfinite(out)
        # nansum returns 0 (not NaN) for all-NaN slices: mask those too, so
        # fully-masked spaxels don't masquerade as genuine zero flux
        if axis is not None:
            mask |= np.all(~np.isfinite(data), axis=axis)
        if out.ndim == 2:
            return Image(data=out, mask=mask if mask.any() else None, wcs=self.wcs,
                         copy=False)
        if out.ndim == 1 and self.ndim == 3 and axis in ((1, 2), (-2, -1)):
            return Spectrum(data=out, mask=mask if mask.any() else None,
                            wave=self.wave, copy=False)
        return out

    def mean(self, axis=None):
        return self._reduce(np.nanmean, axis)

    def sum(self, axis=None):
        return self._reduce(np.nansum, axis)

    def max(self, axis=None):
        return self._reduce(np.nanmax, axis)

    def min(self, axis=None):
        return self._reduce(np.nanmin, axis)

    # -- I/O ----------------------------------------------------------------------
    def _data_header(self):
        """wcs/wave/EXTNAME header for the DATA extension."""
        return data_header(self.shape, self.wcs, self.wave)

    def write(self, filename, savemask="nan", convert_float32=False, **kwargs):
        wire = getattr(self, "_wire16", None)
        if (wire is not None and self.var is None and self.mask is None
                and len(self.shape) == 3 and _store_int16()):
            # a loaded compact file, unmodified: written again in its
            # form, as the same integers at the same scale
            if wire.pairs is not None and _store_sparse():
                write_sparse(filename, *wire.pairs, wire.scale, self.shape,
                             self.primary_header, self._data_header())
                return
            write_int16(filename, requantize(self.data, wire.scale),
                        wire.scale, self.primary_header, self._data_header())
            return
        data = self.data
        if savemask == "nan" and self.mask is not None and data.dtype.kind == "f":
            data = np.array(data, copy=True)
            data[self.mask] = np.nan
        if convert_float32 and data.dtype == np.float64:
            data = data.astype(np.float32)
        dhdr = self._data_header()
        hdus = [
            fitsio.HDU(header=self.primary_header.copy()),
            fitsio.HDU(data=data, header=dhdr),
        ]
        if self.var is not None:
            shdr = dhdr.copy()
            shdr["EXTNAME"] = "STAT"
            hdus.append(fitsio.HDU(data=self.var, header=shdr))
        fitsio.write(filename, hdus)

    def _load(self, filename):
        hdus = fitsio.read(filename)
        self.primary_header = hdus[0].header
        if self.primary_header.get(SPARSE_KEY) and len(hdus) > 1:
            # sparse scaled-int16 cube (see write): scatter the pairs
            # into a dense float32 array, as the dense int16 file's
            # decode gives
            phdr = self.primary_header
            shape = (int(phdr["SPNZ"]), int(phdr["SPNY"]), int(phdr["SPNX"]))
            scale = np.float32(phdr["SPSCALE"])
            tbl = hdus[1]
            flat = np.zeros(int(np.prod(shape)), np.float32)
            idx = np.asarray(tbl.data["IDX"])
            vals = np.asarray(tbl.data["VAL"], np.int16)
            if idx.size:
                flat[idx] = vals.astype(np.float32) * scale
            self.data = flat.reshape(shape)
            self.var = None
            self.mask = None
            hdr = tbl.header
            self.wcs = WCS.from_header(hdr, shape=shape[-2:])
            self.wave = WaveCoord.from_header(hdr, axis=3, shape=shape[0])
            self.data_header = hdr
            # keep the pairs and the header's (float64) scale: a re-park
            # writes the same table
            self._wire16 = Quant16(phdr["SPSCALE"], pairs=(idx, vals))
            del phdr[SPARSE_KEY]  # re-written fresh by write()
            return
        data_hdu = None
        stat_hdu = None
        for h in hdus:
            if h.data is None or isinstance(h.data, dict):
                continue
            if h.name == "DATA" or data_hdu is None and h.name not in ("STAT",):
                if data_hdu is None or h.name == "DATA":
                    data_hdu = h
            if h.name == "STAT":
                stat_hdu = h
        if data_hdu is None:
            raise OSError(f"no image data in {filename}")
        self.data = np.asarray(data_hdu.data)
        self.var = None if stat_hdu is None else np.asarray(stat_hdu.data)
        if self.data.dtype.kind == "f":
            m = ~np.isfinite(self.data)
            self.mask = m if m.any() else None
            self._stamp_nonfinite_mask()
        else:
            self.mask = None
        scale16 = getattr(data_hdu, "scale16", None)
        if scale16 is not None and stat_hdu is None:
            # a scaled-int16 image: keep its scale (see Quant16)
            self._wire16 = Quant16(scale16)
        hdr = data_hdu.header
        shape = self.shape
        if len(shape) >= 2:
            self.wcs = WCS.from_header(hdr, shape=shape[-2:])
        if len(shape) in (1, 3):
            axis = 3 if len(shape) == 3 else 1
            self.wave = WaveCoord.from_header(hdr, axis=axis, shape=shape[0])
        self.data_header = hdr


def _norm_slice(sl, n):
    """``sl`` as a slice: passed through, or an integer's length-1 window
    (numpy negative-index semantics, via :func:`int_window`)."""
    if isinstance(sl, slice):
        return sl
    return int_window(sl, n)


def int_window(i, n):
    """A length-1 slice covering integer index ``i`` of an axis of size
    ``n``, with numpy's negative-index semantics (``-1`` is the last
    element, not an empty window — ``slice(-1, 0)`` would be)."""
    i = int(i)
    if i < 0:
        i += n
    return slice(i, i + 1)


def cutout_window(y, x, size):
    """Start indices of a (size x size) cutout centred at (y, x).

    THE shared convention: Cube.subcube, Image.subimage, TensorCube.subcube
    and the batched device cutouts (artifacts.masks, ops.cutouts) must all
    agree on it, or device windows would silently shift against host ones.
    ``np.rint`` rounds half to even.
    """
    size = int(size)
    return int(np.rint(y)) - size // 2, int(np.rint(x)) - size // 2


def cutout_wcs(wcs, y0, x0, size):
    """WCS of a (size x size) cutout starting at pixel (y0, x0)."""
    if wcs is None:
        return None
    return WCS(
        crpix=(wcs.crpix[0] - y0, wcs.crpix[1] - x0),
        crval=tuple(wcs.crval),
        cd=wcs.cd.copy(),
        shape=(size, size),
    )


class Cube(_Base):
    """(Nz, Ny, Nx) spectral cube."""

    _ndim = 3

    def _region(self, zsl, ysl, xsl):
        """(data, var, mask) blocks for a rectangular region."""
        return (
            self.data[zsl, ysl, xsl],
            None if self.var is None else self.var[zsl, ysl, xsl],
            None if self.mask is None else self.mask[zsl, ysl, xsl],
        )

    def __getitem__(self, item):
        if isinstance(item, (int, np.integer)):
            item = (item,)
        if not isinstance(item, tuple):
            item = (item,)
        item = item + (slice(None),) * (3 - len(item))
        zsl, ysl, xsl = item
        if all(isinstance(sl, (int, np.integer, slice))
               for sl in (zsl, ysl, xsl)):
            data, var, mask = self._region(zsl, ysl, xsl)
        else:
            # fancy (array/boolean) indexing: plain numpy semantics on
            # the dense arrays
            data = self.data[zsl, ysl, xsl]
            var = self.var[zsl, ysl, xsl] if self.var is not None else None
            mask = (self.mask[zsl, ysl, xsl]
                    if self.mask is not None else None)
        if data.ndim == 3:
            wave = self.wave[_norm_slice(zsl, self.shape[0])] if (
                self.wave is not None and isinstance(zsl, slice)) else self.wave
            wcs = self.wcs[ysl, xsl] if self.wcs is not None else None
            return Cube(data=data, var=var, mask=mask, wcs=wcs, wave=wave, copy=False)
        z_int = not isinstance(zsl, slice)
        if data.ndim == 2 and z_int:  # one channel
            wcs = self.wcs[ysl, xsl] if self.wcs is not None else None
            return Image(data=data, var=var, mask=mask, wcs=wcs, copy=False)
        if data.ndim == 1 and not z_int:  # one spaxel
            wave = (
                self.wave[zsl] if self.wave is not None else None
            )
            return Spectrum(data=data, var=var, mask=mask, wave=wave, copy=False)
        # cross-sections (e.g. cube[:, 2, :] or cube[2, 3, :]) have no
        # well-defined Cube/Image/Spectrum coordinates: return the raw array
        return data

    def subcube(self, center, size, lbda=None, unit_center=None, unit_size=None):
        """Extract a (size x size) spatial cutout centred on ``center``.

        ``center`` is (y, x) in pixels when ``unit_center`` is None, else
        (dec, ra) in degrees.  The returned cube always has the requested
        size; pixels outside the field are masked.
        """
        if unit_center is not None:
            (y, x), = self.wcs.sky2pix([center])
        else:
            y, x = center
        size = int(size)
        nz, ny, nx = self.shape
        y0, x0 = cutout_window(y, x, size)
        zsl = slice(0, nz)
        if lbda is not None:
            k1 = int(self.wave.pixel(lbda[0], nearest=True))
            k2 = int(self.wave.pixel(lbda[1], nearest=True))
            zsl = slice(k1, k2 + 1)
        nzz = zsl.stop - zsl.start
        sy0, sy1 = max(0, y0), min(ny, y0 + size)
        sx0, sx1 = max(0, x0), min(nx, x0 + size)
        wcs = cutout_wcs(self.wcs, y0, x0, size)
        wave = self._copy_wave()
        if lbda is not None and wave is not None:
            wave = self.wave[zsl]
        if sy1 - sy0 == size and sx1 - sx0 == size:
            # fully in-field window (the common case): one contiguous copy
            # per array, no fill pass
            dblock, vblock, mblock = self._region(
                zsl, slice(y0, y0 + size), slice(x0, x0 + size)
            )
            data = np.array(dblock, order="C", copy=True)
            var = (None if vblock is None
                   else np.array(vblock, order="C", copy=True))
            mask = (np.array(mblock, order="C", copy=True)
                    if mblock is not None
                    else np.zeros((nzz, size, size), dtype=bool))
            return Cube(data=data, var=var, mask=mask, wcs=wcs, wave=wave,
                        copy=False)
        data = np.zeros((nzz, size, size), dtype=self.dtype)
        mask = np.ones((nzz, size, size), dtype=bool)
        var = None
        if self.var is not None:
            var = np.full((nzz, size, size), np.inf, dtype=self.var.dtype)
        if sy0 < sy1 and sx0 < sx1:
            dy0, dx0 = sy0 - y0, sx0 - x0
            dblock, vblock, mblock = self._region(
                zsl, slice(sy0, sy1), slice(sx0, sx1)
            )
            data[:, dy0 : dy0 + sy1 - sy0, dx0 : dx0 + sx1 - sx0] = dblock
            mask[:, dy0 : dy0 + sy1 - sy0, dx0 : dx0 + sx1 - sx0] = (
                mblock if mblock is not None else False
            )
            if var is not None and vblock is not None:
                var[:, dy0 : dy0 + sy1 - sy0, dx0 : dx0 + sx1 - sx0] = vblock
        return Cube(data=data, var=var, mask=mask, wcs=wcs, wave=wave, copy=False)

    def get_image(self, wave, unit_wave=None, method="sum"):
        """Image reduced over an (inclusive) spectral range.

        ``wave`` is (zmin, zmax) in pixels when ``unit_wave`` is None, else in
        wavelength units.
        """
        z1, z2 = wave
        if unit_wave is not None:
            z1 = int(self.wave.pixel(z1, nearest=True))
            z2 = int(self.wave.pixel(z2, nearest=True))
        z1 = max(0, int(z1))
        z2 = min(self.shape[0] - 1, int(z2))
        sub, _, msub = self._region(
            slice(z1, z2 + 1), slice(None), slice(None))
        import warnings

        func = {"sum": np.nansum, "mean": np.nanmean, "max": np.nanmax}[method]
        if msub is not None:
            sub = np.where(msub, np.nan, sub)
        with np.errstate(invalid="ignore"), warnings.catch_warnings():
            warnings.simplefilter("ignore", category=RuntimeWarning)
            img = func(sub, axis=0)
        mask = ~np.isfinite(img)
        if method == "sum":
            mask |= np.all(~np.isfinite(sub), axis=0)
        img = np.where(mask, 0.0, img)
        return Image(data=img, mask=mask if mask.any() else None, wcs=self.wcs,
                     copy=False)


class Image(_Base):
    """(Ny, Nx) image."""

    _ndim = 2

    def __getitem__(self, item):
        if not isinstance(item, tuple):
            item = (item, slice(None))
        ysl, xsl = item
        data = self.data[ysl, xsl]
        var = self.var[ysl, xsl] if self.var is not None else None
        mask = self.mask[ysl, xsl] if self.mask is not None else None
        if data.ndim == 2:
            wcs = self.wcs[ysl, xsl] if self.wcs is not None else None
            return Image(data=data, var=var, mask=mask, wcs=wcs, copy=False)
        return data

    def subimage(self, center, size, unit_center=None, unit_size=None):
        if unit_center is not None:
            (y, x), = self.wcs.sky2pix([center])
        else:
            y, x = center
        size = int(size)
        ny, nx = self.shape
        y0, x0 = cutout_window(y, x, size)
        data = np.zeros((size, size), dtype=self.data.dtype)
        mask = np.ones((size, size), dtype=bool)
        sy0, sy1 = max(0, y0), min(ny, y0 + size)
        sx0, sx1 = max(0, x0), min(nx, x0 + size)
        if sy0 < sy1 and sx0 < sx1:
            dy0, dx0 = sy0 - y0, sx0 - x0
            data[dy0 : dy0 + sy1 - sy0, dx0 : dx0 + sx1 - sx0] = self.data[
                sy0:sy1, sx0:sx1
            ]
            mask[dy0 : dy0 + sy1 - sy0, dx0 : dx0 + sx1 - sx0] = (
                self.mask[sy0:sy1, sx0:sx1] if self.mask is not None else False
            )
        wcs = cutout_wcs(self.wcs, y0, x0, size)
        return Image(data=data, mask=mask, wcs=wcs, copy=False)


class Spectrum(_Base):
    """(Nz,) spectrum."""

    _ndim = 1

    def __getitem__(self, item):
        data = self.data[item]
        var = self.var[item] if self.var is not None else None
        mask = self.mask[item] if self.mask is not None else None
        if np.ndim(data) == 1:
            wave = self.wave[item] if (
                self.wave is not None and isinstance(item, slice)) else None
            return Spectrum(data=data, var=var, mask=mask, wave=wave, copy=False)
        return data

    def subspec(self, lmin, lmax, unit=None):
        """Trimmed spectrum over [lmin, lmax] (pixels when unit is None)."""
        if unit is not None:
            lmin = int(self.wave.pixel(lmin, nearest=True))
            lmax = int(self.wave.pixel(lmax, nearest=True))
        lmin = max(0, int(lmin))
        lmax = min(self.shape[0] - 1, int(lmax))
        return self[lmin : lmax + 1]
