"""Cube / Image / Spectrum containers.

(The port's copy of the part of ``origin_tpu/core/containers.py`` that steps
01-09 use: float data with optional variance and mask, world coordinates, FITS
reads and writes, the reductions of a session's white image, and the
trimmed per-line spectra of step 08.)

Replaces the subset of ``mpdaf.obj.Cube/Image/Spectrum`` used by the reference
(see reference steps.py:284-299): data + optional variance + optional boolean
mask (True = invalid), world coordinates, and FITS round-trips (DATA/STAT
extensions with NaN-encoded masks).
"""

from __future__ import annotations

import numpy as np

from .. import fitsio
from .coords import WCS, WaveCoord

__all__ = ["Cube", "Image", "Spectrum"]


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
        dhdr = fitsio.Header()
        shape = self.shape
        if self.wcs is not None:
            self.wcs.to_header(dhdr)
        if self.wave is not None and len(shape) in (1, 3):
            self.wave.to_header(dhdr, axis=3 if len(shape) == 3 else 1)
        dhdr["EXTNAME"] = "DATA"
        return dhdr

    def write(self, filename, savemask="nan", convert_float32=False, **kwargs):
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
        hdr = data_hdu.header
        shape = self.shape
        if len(shape) >= 2:
            self.wcs = WCS.from_header(hdr, shape=shape[-2:])
        if len(shape) in (1, 3):
            axis = 3 if len(shape) == 3 else 1
            self.wave = WaveCoord.from_header(hdr, axis=axis, shape=shape[0])
        self.data_header = hdr


class Cube(_Base):
    """(Nz, Ny, Nx) spectral cube."""

    _ndim = 3


class Image(_Base):
    """(Ny, Nx) image."""

    _ndim = 2


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
