"""World coordinate systems for MUSE-like datacubes.

(The port's copy of ``origin_tpu/core/coords.py``, unchanged apart from this note.)

Replaces the subset of ``mpdaf.obj.WCS`` / ``mpdaf.obj.WaveCoord`` used by the
reference (see reference origin.py:217-219, steps.py:284-299,
lib_origin.py:1922-1925): a 2-D celestial gnomonic (TAN) projection with a CD
matrix, and a linear 1-D wavelength axis.

Conventions (matching mpdaf):
- pixel coordinates are (y, x) i.e. (row, col), zero-based;
- ``pix2sky`` takes an (N, 2) array of (y, x) and returns (N, 2) of (dec, ra)
  in degrees;
- ``WaveCoord.coord(k)`` returns the wavelength in Angstrom of pixel ``k``.
"""

from __future__ import annotations

import numpy as np

from ..fitsio import Header

__all__ = ["WCS", "WaveCoord"]

DEG = np.pi / 180.0


class WCS:
    """Celestial WCS: TAN projection with CD matrix (deg/pixel)."""

    def __init__(self, crpix=(1.0, 1.0), crval=(0.0, 0.0), cd=None, cdelt=2e-4 / 3.6,
                 shape=None):
        # crpix/crval stored as (y, x) <-> (dec, ra); FITS keywords are 1-based
        self.crpix = np.asarray(crpix, dtype=float)  # (crpix2, crpix1)
        self.crval = np.asarray(crval, dtype=float)  # (crval2=dec, crval1=ra)
        if cd is None:
            # rows: (dy, dx) in intermediate coords; default square pixels
            # MUSE pixel = 0.2 arcsec = 2e-4/3.6 deg
            cd = np.array([[cdelt, 0.0], [0.0, -cdelt]])
        # cd is [[CD2_2, CD2_1], [CD1_2, CD1_1]] in our (y, x) ordering:
        # intermediate (eta, xi) = cd @ (y - crpix_y, x - crpix_x)
        self.cd = np.asarray(cd, dtype=float)
        self.shape = tuple(shape) if shape is not None else None

    # -- projection ---------------------------------------------------------
    def _pix2native(self, pix):
        pix = np.atleast_2d(np.asarray(pix, dtype=float))
        rel = pix - self.crpix[None, :]
        inter = rel @ self.cd.T  # (eta, xi) in degrees
        return inter[:, 0], inter[:, 1]

    def pix2sky(self, pix):
        """(N,2) of (y,x) -> (N,2) of (dec, ra) in degrees (TAN projection)."""
        eta, xi = self._pix2native(pix)
        xi = xi * DEG
        eta = eta * DEG
        ra0 = self.crval[1] * DEG
        dec0 = self.crval[0] * DEG
        # gnomonic deprojection
        rho = np.hypot(xi, eta)
        c = np.arctan(rho)
        with np.errstate(invalid="ignore", divide="ignore"):
            sinc = np.where(rho > 0, np.sin(c) / np.where(rho > 0, rho, 1), 1.0)
        dec = np.arcsin(np.cos(c) * np.sin(dec0) + eta * sinc * np.cos(dec0))
        ra = ra0 + np.arctan2(
            xi * sinc, np.cos(dec0) * np.cos(c) - eta * sinc * np.sin(dec0)
        )
        out = np.stack([dec / DEG, ra / DEG], axis=1)
        return out

    def sky2pix(self, sky, nearest=False):
        """(N,2) of (dec, ra) deg -> (N,2) of (y,x) pixels."""
        sky = np.atleast_2d(np.asarray(sky, dtype=float))
        dec = sky[:, 0] * DEG
        ra = sky[:, 1] * DEG
        ra0 = self.crval[1] * DEG
        dec0 = self.crval[0] * DEG
        cosc = np.sin(dec0) * np.sin(dec) + np.cos(dec0) * np.cos(dec) * np.cos(
            ra - ra0
        )
        xi = np.cos(dec) * np.sin(ra - ra0) / cosc
        eta = (
            np.cos(dec0) * np.sin(dec) - np.sin(dec0) * np.cos(dec) * np.cos(ra - ra0)
        ) / cosc
        inter = np.stack([eta / DEG, xi / DEG], axis=1)
        rel = inter @ np.linalg.inv(self.cd).T
        pix = rel + self.crpix[None, :]
        if nearest:
            pix = np.round(pix).astype(int)
        return pix

    def get_step(self, unit="deg"):
        """Pixel scales (dy, dx). unit: 'deg' or 'arcsec'."""
        step = np.sqrt(np.sum(self.cd ** 2, axis=1))
        if unit in ("arcsec", "asec"):
            step = step * 3600.0
        return step

    # -- slicing (cutouts) ----------------------------------------------------
    def __getitem__(self, item):
        """Return the WCS of a (yslice, xslice) cutout.

        Integer indices are treated as length-1 slices; negative slice
        starts resolve against the known shape (numpy semantics).
        """
        ysl, xsl = item
        if not isinstance(ysl, slice):
            ysl = slice(int(ysl), int(ysl) + 1)
        if not isinstance(xsl, slice):
            xsl = slice(int(xsl), int(xsl) + 1)

        def _start(sl, n):
            if sl.start is None:
                return 0
            if sl.start < 0:
                if n is None:
                    raise ValueError(
                        "negative slice start needs a WCS with a shape"
                    )
                return sl.indices(n)[0]
            return sl.start

        y0 = _start(ysl, None if self.shape is None else self.shape[0])
        x0 = _start(xsl, None if self.shape is None else self.shape[1])
        new = WCS(
            crpix=(self.crpix[0] - y0, self.crpix[1] - x0),
            crval=tuple(self.crval),
            cd=self.cd.copy(),
        )
        if self.shape is not None:
            ny = len(range(*ysl.indices(self.shape[0])))
            nx = len(range(*xsl.indices(self.shape[1])))
            new.shape = (ny, nx)
        return new

    # -- FITS header ----------------------------------------------------------
    def to_header(self, hdr=None, naxis_offset=0):
        hdr = hdr if hdr is not None else Header()
        i = 1 + naxis_offset  # x axis index
        j = 2 + naxis_offset  # y axis index
        hdr[f"CRPIX{i}"] = self.crpix[1] + 1
        hdr[f"CRPIX{j}"] = self.crpix[0] + 1
        hdr[f"CRVAL{i}"] = self.crval[1]
        hdr[f"CRVAL{j}"] = self.crval[0]
        hdr[f"CTYPE{i}"] = "RA---TAN"
        hdr[f"CTYPE{j}"] = "DEC--TAN"
        hdr[f"CUNIT{i}"] = "deg"
        hdr[f"CUNIT{j}"] = "deg"
        hdr[f"CD{i}_{i}"] = self.cd[1, 1]
        hdr[f"CD{i}_{j}"] = self.cd[1, 0]
        hdr[f"CD{j}_{i}"] = self.cd[0, 1]
        hdr[f"CD{j}_{j}"] = self.cd[0, 0]
        return hdr

    @classmethod
    def from_header(cls, hdr, naxis_offset=0, shape=None):
        i = 1 + naxis_offset
        j = 2 + naxis_offset
        if f"CRPIX{i}" not in hdr:
            return cls(shape=shape)
        crpix = (float(hdr[f"CRPIX{j}"]) - 1, float(hdr[f"CRPIX{i}"]) - 1)
        crval = (float(hdr.get(f"CRVAL{j}", 0.0)), float(hdr.get(f"CRVAL{i}", 0.0)))
        if f"CD{i}_{i}" in hdr:
            cd = np.array(
                [
                    [float(hdr.get(f"CD{j}_{j}", 1.0)), float(hdr.get(f"CD{j}_{i}", 0.0))],
                    [float(hdr.get(f"CD{i}_{j}", 0.0)), float(hdr.get(f"CD{i}_{i}", 1.0))],
                ]
            )
        else:
            cdx = float(hdr.get(f"CDELT{i}", 1.0))
            cdy = float(hdr.get(f"CDELT{j}", 1.0))
            cd = np.array([[cdy, 0.0], [0.0, cdx]])
        return cls(crpix=crpix, crval=crval, cd=cd, shape=shape)

    def __eq__(self, other):
        if not isinstance(other, WCS):
            return NotImplemented
        return (
            np.allclose(self.crpix, other.crpix)
            and np.allclose(self.crval, other.crval)
            and np.allclose(self.cd, other.cd)
        )


class WaveCoord:
    """Linear wavelength axis (Angstrom)."""

    def __init__(self, crpix=1.0, crval=4750.0, cdelt=1.25, ctype="AWAV", shape=None):
        self.crpix = float(crpix)  # 1-based, FITS convention
        self.crval = float(crval)
        self.cdelt = float(cdelt)
        self.ctype = ctype
        self.shape = shape

    def coord(self, pixel=None):
        """Wavelength(s) of pixel index/indices (zero-based)."""
        if pixel is None:
            if self.shape is None:
                raise ValueError("need shape to return full axis")
            pixel = np.arange(self.shape)
        pixel = np.asarray(pixel, dtype=float)
        return self.crval + (pixel - (self.crpix - 1)) * self.cdelt

    def pixel(self, lbda, nearest=False):
        pix = (np.asarray(lbda, dtype=float) - self.crval) / self.cdelt + (
            self.crpix - 1
        )
        if nearest:
            pix = np.rint(pix).astype(int)
            if self.shape is not None:
                pix = np.clip(pix, 0, self.shape - 1)
        return pix

    def get_step(self, unit="angstrom"):
        return self.cdelt

    def get_start(self):
        return self.coord(0)

    def get_end(self):
        return self.coord(self.shape - 1) if self.shape else None

    def __getitem__(self, item):
        """Wave coordinate of a spectral slice."""
        if isinstance(item, slice):
            start = item.start or 0
            if start < 0:
                if not self.shape:
                    raise ValueError(
                        "negative slice start needs a WaveCoord with a shape"
                    )
                start = item.indices(self.shape)[0]
            n = len(range(*item.indices(self.shape))) if self.shape else None
            return WaveCoord(
                crpix=1.0,
                crval=self.coord(start),
                cdelt=self.cdelt * (item.step or 1),
                ctype=self.ctype,
                shape=n,
            )
        raise TypeError("WaveCoord only supports slices")

    def to_header(self, hdr=None, axis=3):
        hdr = hdr if hdr is not None else Header()
        hdr[f"CRPIX{axis}"] = self.crpix
        hdr[f"CRVAL{axis}"] = self.crval
        hdr[f"CD{axis}_{axis}"] = self.cdelt
        hdr[f"CTYPE{axis}"] = self.ctype
        hdr[f"CUNIT{axis}"] = "Angstrom"
        return hdr

    @classmethod
    def from_header(cls, hdr, axis=3, shape=None):
        if f"CRVAL{axis}" not in hdr:
            return None
        cdelt = hdr.get(f"CD{axis}_{axis}", hdr.get(f"CDELT{axis}", 1.0))
        return cls(
            crpix=float(hdr.get(f"CRPIX{axis}", 1.0)),
            crval=float(hdr[f"CRVAL{axis}"]),
            cdelt=float(cdelt),
            ctype=str(hdr.get(f"CTYPE{axis}", "AWAV")),
            shape=shape,
        )

    def __eq__(self, other):
        if not isinstance(other, WaveCoord):
            return NotImplemented
        return (
            np.isclose(self.crpix, other.crpix)
            and np.isclose(self.crval, other.crval)
            and np.isclose(self.cdelt, other.cdelt)
        )
