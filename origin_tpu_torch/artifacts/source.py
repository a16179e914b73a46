"""Per-source FITS file container.

(The port's copy of ``origin_tpu/artifacts/source.py``, without the int16
cutouts of the JAX package's session files and without ``append_cube``,
which only its two-phase writer used; ``add_FSF`` also records the FSF of
a source in a multi-field cube, where the JAX package's step 11 fails.)

Replaces the subset of ``mpdaf.sdetect.Source`` used by the reference's
source-file writer (source_creation.py:26-436): a primary header of source
keywords plus named cubes, images, spectra and tables serialized as FITS
extensions with the mpdaf naming convention (IMA_*, CUB_*_DATA/STAT,
SPE_*_DATA/STAT, TAB_*).

Spectral extraction conventions (extract_spectra): the sky spectrum is the
mean over the sky mask; the total spectrum is the plain sum over the object
mask; weighted spectra (white-light, PSF, correlation-map) use the
inverse-variance matched estimator sum(w d / var) / sum(w^2 / var) with the
weights normalized to a unit peak inside the mask.
"""

from __future__ import annotations

import threading
from datetime import datetime

import numpy as np

from .. import fitsio
from ..core.containers import Cube, Image, Spectrum
from ..core.fsf import (
    SOURCE_FIELD,
    combine_fsf,
    read_field_fsf,
    read_fsf_from_header,
)
from ..core.table import Table

__all__ = ["Source"]


_MOFFAT_CACHE = {}
_MOFFAT_LOCK = threading.Lock()  # step 11 builds sources in threads


def _moffat_weight_cube(ny, nx, step, psf, beta):
    """(Nz, ny, nx) Moffat (or Gaussian) PSF weight cube, cached.

    Keyed by the cutout geometry and the FWHM/beta vectors' bytes; a run
    reuses one entry per cutout size, so the cache stays tiny.
    """
    key = (
        ny, nx, round(step, 9), psf.tobytes(),
        None if beta is None else np.asarray(beta, np.float32).tobytes(),
    )
    with _MOFFAT_LOCK:
        hit = _MOFFAT_CACHE.get(key)
        if hit is None:
            hit = _MOFFAT_CACHE[key] = _moffat_cube(ny, nx, step, psf, beta)
            if len(_MOFFAT_CACHE) > 4:
                _MOFFAT_CACHE.pop(next(iter(_MOFFAT_CACHE)))
        return hit


def _moffat_cube(ny, nx, step, psf, beta):
    cy, cx = (ny - 1) / 2.0, (nx - 1) / 2.0
    yy, xx = np.mgrid[:ny, :nx]
    r2 = ((yy - cy) ** 2 + (xx - cx) ** 2).astype(np.float32)
    fwhm_pix = psf / np.float32(step)
    if beta is not None:
        b = np.asarray(beta, dtype=np.float32)
        alpha = fwhm_pix / (2 * np.sqrt(2 ** (1.0 / b) - 1))
        wcube = (1 + r2[None] / (alpha ** 2)[:, None, None]) ** (
            -b[:, None, None]
        )
    else:
        sig = fwhm_pix / np.float32(2 * np.sqrt(2 * np.log(2)))
        wcube = np.exp(-0.5 * r2[None] / (sig ** 2)[:, None, None])
    return wcube


def _coord_header(obj, is_cube):
    """WCS/wave FITS cards of one attached data object."""
    hdr = fitsio.Header()
    if getattr(obj, "wcs", None) is not None:
        obj.wcs.to_header(hdr)
    if getattr(obj, "wave", None) is not None:
        obj.wave.to_header(hdr, axis=3 if is_cube else 1)
    return hdr


def _cube_hdus(name, cube):
    """The CUB_<name>_DATA[/_STAT] HDUs of one cutout cube: masked
    voxels as NaN, float32."""
    hdus = []
    hdr = _coord_header(cube, True)
    hdr["EXTNAME"] = f"CUB_{name}_DATA"
    data = cube.data
    if data.dtype.kind == "f" and cube.mask is not None:
        # raw-cube cutouts carry NaN at masked voxels already — skip the
        # full-cutout fill copy then
        masked = data[cube.mask]
        if not np.isnan(masked).all():
            data = np.where(cube.mask, np.nan, data)
    hdus.append(fitsio.HDU(
        data=data.astype(np.float32, copy=False), header=hdr))
    if cube.var is not None:
        vhdr = _coord_header(cube, True)
        vhdr["EXTNAME"] = f"CUB_{name}_STAT"
        hdus.append(fitsio.HDU(
            data=cube.var.astype(np.float32, copy=False), header=vhdr))
    return hdus


class Source:
    def __init__(self, header=None):
        self.header = header if header is not None else fitsio.Header()
        self.cubes = {}
        self.images = {}
        self.spectra = {}
        self.tables = {}
        self.lines = None

    # -- construction -------------------------------------------------------
    @classmethod
    def from_data(cls, source_id, ra, dec, origin):
        src = cls()
        h = src.header
        h["ID"] = int(source_id), "object ID"
        h["RA"] = float(ra), "RA in degrees"
        h["DEC"] = float(dec), "DEC in degrees"
        h["FROM"] = origin[0], "detection software"
        h["FROM_V"] = origin[1], "version of the detection software"
        h["CUBE"] = origin[2], "datacube"
        h["CUBE_V"] = origin[3] if origin[3] else "", "version of the datacube"
        return src

    def __getattr__(self, name):
        # header keyword access (e.g. source.COMP_CAT)
        hdr = self.__dict__.get("header")
        if hdr is not None and name in hdr:
            return hdr[name]
        raise AttributeError(name)

    def add_history(self, text, author=""):
        stamp = datetime.now().isoformat()[:19]
        self.header.add_history(f"{text} ({author}) {stamp}" if author else
                                f"{text} {stamp}")

    # -- data attachment ------------------------------------------------------
    def add_cube(self, cube, name, size=None, unit_size=None, add_white=False):
        """Attach a spatial cutout of ``cube`` centred on the source."""
        if size is None:
            sub = cube.copy()
        else:
            sub = cube.subcube(
                center=(self.header["DEC"], self.header["RA"]), size=size,
                unit_center="deg",
            )
        self.cubes[name] = sub
        if add_white:
            self.images["MUSE_WHITE"] = sub.mean(axis=0)
        return sub

    def add_image(self, image, name):
        """Attach an image resampled on the white-image grid (or as given)."""
        white = self.images.get("MUSE_WHITE")
        if white is not None and image.shape != white.shape:
            size = white.shape[0]
            image = image.subimage(
                center=(self.header["DEC"], self.header["RA"]), size=size,
                unit_center="deg",
            )
        self.images[name] = image
        return image

    def add_FSF(self, cube, fieldmap=None, weights=None):
        """Copy the FSF model keywords from a cube header.

        A header of several fields also gets the source's own FSF, the
        fields' models averaged with ``weights`` (the fields' weights at
        the source, :func:`~origin_tpu_torch.core.fsf.field_weights`), as
        field ``SOURCE_FIELD``, which :meth:`get_FSF` reads.
        """
        hdr = cube.primary_header
        if "FSFMODE" not in hdr:
            raise ValueError("no FSF keywords in the cube header")
        for key in hdr.keys():
            if key.startswith("FSF"):
                self.header[key] = hdr[key]
        step = cube.wcs.get_step(unit="arcsec")[0] if cube.wcs else 0.2
        self.header["FSFSTEP"] = float(step), "pixel step used for FSF (arcsec)"
        models = read_fsf_from_header(hdr, pixstep=float(step))
        if isinstance(models, list):
            if weights is None:
                raise ValueError(
                    f"the cube header holds {len(models)} FSF fields: the "
                    "source's field weights are needed")
            combine_fsf(models, weights).to_header(self.header)

    def get_FSF(self):
        """The source's FSF: its own if the cube had several fields."""
        pixstep = float(self.header.get("FSFSTEP", 0.2))
        if f"FSF{SOURCE_FIELD:02d}FNC" in self.header:
            return read_field_fsf(self.header, SOURCE_FIELD, pixstep)
        return read_fsf_from_header(self.header, pixstep=pixstep)

    def add_table(self, tbl, name, select_in=None, col_dist=None):
        self.tables[name] = tbl.copy()

    def add_line(self, cols, values, units=None, fmt=None, desc=None):
        if self.lines is None:
            self.lines = Table(data=[[v] for v in values], names=list(cols))
        else:
            for c in cols:
                if c not in self.lines.colnames:
                    self.lines[c] = np.full(len(self.lines), np.nan)
            self.lines.add_row(dict(zip(cols, values)))

    # -- narrow bands -----------------------------------------------------------
    def add_narrow_band_image_lbdaobs(
        self, cube, name, lbda, width=8, method="sum", subtract_off=True,
        margin=10.0, fband=3.0,
    ):
        """Narrow-band image around an observed wavelength.

        With ``subtract_off`` the mean of two side bands (offset by
        ``margin`` Angstrom, total width ``fband`` times the band) scaled to
        the band width is subtracted (reference usage:
        source_creation.py:377-399).
        """
        l1, l2 = lbda - width / 2.0, lbda + width / 2.0
        z1 = int(max(0, cube.wave.pixel(l1, nearest=True)))
        z2 = int(min(cube.shape[0] - 1, cube.wave.pixel(l2, nearest=True)))
        import warnings

        # one NaN-filled copy per cutout, shared by every line's on/off
        # bands (filled() re-copies the cube per call otherwise)
        data = getattr(cube, "_filled_nan", None)
        if data is None:
            data = cube.filled(np.nan)
            try:
                cube._filled_nan = data
            except Exception:
                pass
        on = data[z1 : z2 + 1]
        with warnings.catch_warnings():
            # all-NaN spaxels (field edges) reduce to NaN -> zeroed below
            warnings.simplefilter("ignore", category=RuntimeWarning)
            if method == "sum":
                img = np.nansum(on, axis=0)
            elif method == "mean":
                img = np.nanmean(on, axis=0)
            else:
                img = np.nanmax(on, axis=0)
        if subtract_off and method == "sum":
            half = fband * width / 2.0
            zl1 = int(max(0, cube.wave.pixel(l1 - margin - half, nearest=True)))
            zl2 = int(max(0, cube.wave.pixel(l1 - margin, nearest=True)))
            zr1 = int(min(cube.shape[0] - 1,
                          cube.wave.pixel(l2 + margin, nearest=True)))
            zr2 = int(min(cube.shape[0] - 1,
                          cube.wave.pixel(l2 + margin + half, nearest=True)))
            off = []
            if zl2 > zl1:
                off.append(data[zl1:zl2])
            if zr2 > zr1:
                off.append(data[zr1:zr2])
            if off:
                off = np.concatenate(off, axis=0)
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", category=RuntimeWarning)
                    img = img - np.nanmean(off, axis=0) * (z2 + 1 - z1)
        img = np.where(np.isfinite(img), img, 0.0)
        self.images[name] = Image(data=img, wcs=cube.wcs, copy=False)

    # -- spectra -------------------------------------------------------------------
    @staticmethod
    def _cube_arrays(cube):
        """(data0, valid, inv) for a cutout cube, cached on the instance.

        extract_spectra runs ~6 times per source on the same cutout (sky /
        skysub variants, PSF-weighted, per-line correlation-weighted);
        the zero-filled data, validity mask and inverse variance are
        identical across those calls.
        """
        cache = getattr(cube, "_extract_cache", None)
        if cache is None:
            raw = np.asarray(cube.data, dtype=np.float32)
            valid = np.isfinite(raw)
            if cube.mask is not None:
                valid &= ~cube.mask
            data0 = np.where(valid, raw, np.float32(0.0))
            if cube.var is not None:
                v = np.asarray(cube.var, dtype=np.float32)
                with np.errstate(divide="ignore", invalid="ignore"):
                    inv = np.where(
                        valid & np.isfinite(v) & (v > 0), 1.0 / v, 0.0
                    ).astype(np.float32)
            else:
                inv = valid.astype(np.float32)
            cache = (data0, valid, inv)
            try:
                cube._extract_cache = cache
            except Exception:
                pass
        return cache

    @staticmethod
    def _weighted_spectrum_fast(dv, inv, weights, mask):
        """Variance-weighted spectrum from precomputed data/var products.

        ``dv`` = zero-filled data / var, ``inv`` = 1/var (0 at invalid
        voxels); one einsum pass per reduction, float32 throughout.
        """
        w = np.where(mask, weights, 0.0).astype(np.float32)
        peak = w.max()
        if peak > 0:
            w = w / peak
        num = np.einsum("zyx,yx->z", dv, w)
        den = np.einsum("zyx,yx->z", inv, w * w)
        den[den == 0] = np.inf
        return num / den, 1.0 / den

    def extract_spectra(
        self, cube, obj_mask="ORI_MASK_OBJ", sky_mask="ORI_MASK_SKY",
        skysub=True, psf=None, beta=None, tags_to_try=None,
    ):
        """Extract total / weighted spectra over the object mask.

        Produces MUSE_SKY, MUSE_TOT[_SKYSUB], MUSE_WHITE[_SKYSUB], and
        MUSE_PSF[_SKYSUB] when a psf FWHM vector is given, plus one weighted
        spectrum per entry of ``tags_to_try`` whose image exists.

        Implementation note: invalid voxels contribute 0 to every sum (the
        reference's NaN/inf-variance arithmetic reaches the same values);
        everything is evaluated from one zero-filled float32 data cube and
        one inverse-variance cube, shared across all extracted spectra.
        """
        objm = np.asarray(self.images[obj_mask].data) > 0
        skym = np.asarray(self.images[sky_mask].data) > 0
        suffix = "_SKYSUB" if skysub else ""

        data, valid, inv = self._cube_arrays(cube)

        nsky = max(1, skym.sum())
        sky = np.einsum("zyx,yx->z", data, skym.astype(np.float32)) / nsky
        self.spectra["MUSE_SKY"] = Spectrum(data=sky, wave=cube.wave, copy=False)
        if skysub:
            data = np.where(valid, data - sky[:, None, None], np.float32(0.0))

        tot = np.einsum("zyx,yx->z", data, objm.astype(np.float32))
        self.spectra["MUSE_TOT" + suffix] = Spectrum(
            data=tot, wave=cube.wave, copy=False
        )

        dv = data * inv  # shared by every weighted estimator below

        white = self.images.get("MUSE_WHITE")
        if white is not None:
            spec, svar = self._weighted_spectrum_fast(
                dv, inv, np.asarray(white.data, np.float32), objm
            )
            self.spectra["MUSE_WHITE" + suffix] = Spectrum(
                data=spec, var=svar, wave=cube.wave, copy=False
            )

        if psf is not None:
            # Moffat (or Gaussian if beta is None) weight cube centred on the
            # source, collapsed with the matched estimator.  The cube depends
            # only on (cutout shape, pixel step, FWHM/beta vectors) — i.e. it
            # is identical for every source of a run — so it is cached
            # module-wide: building it costs ~2.3 M pow() calls per source.
            ny, nx = data.shape[1:]
            psf = np.asarray(psf, dtype=np.float32)
            step = cube.wcs.get_step(unit="arcsec")[0] if cube.wcs else 0.2
            wcube = _moffat_weight_cube(ny, nx, float(step), psf, beta)
            w = wcube * objm[None]
            num = np.einsum("zyx,zyx->z", w, dv)
            den = np.einsum("zyx,zyx->z", w * w, inv)
            den[den == 0] = np.inf
            self.spectra["MUSE_PSF" + suffix] = Spectrum(
                data=num / den, var=1.0 / den, wave=cube.wave, copy=False
            )

        if tags_to_try:
            for tag in tags_to_try:
                img = self.images.get(tag)
                if img is None:
                    continue
                spec, svar = self._weighted_spectrum_fast(
                    dv, inv, np.asarray(img.data, np.float32), objm
                )
                self.spectra[tag + suffix] = Spectrum(
                    data=spec, var=svar, wave=cube.wave, copy=False
                )

    # -- I/O ------------------------------------------------------------------------
    def write(self, filename):
        hdus = [fitsio.HDU(header=self.header.copy())]

        for name, img in self.images.items():
            hdr = _coord_header(img, False)
            hdr["EXTNAME"] = f"IMA_{name}"
            data = img.data
            if data.dtype.kind == "f" and img.mask is not None:
                data = np.where(img.mask, np.nan, data)
            hdus.append(fitsio.HDU(data=data, header=hdr))
        for name, cube in self.cubes.items():
            hdus.extend(_cube_hdus(name, cube))
        for name, sp in self.spectra.items():
            hdr = _coord_header(sp, False)
            hdr["EXTNAME"] = f"SPE_{name}_DATA"
            hdus.append(fitsio.HDU(data=np.asarray(sp.data, np.float64),
                                   header=hdr))
            if sp.var is not None:
                vhdr = _coord_header(sp, False)
                vhdr["EXTNAME"] = f"SPE_{name}_STAT"
                hdus.append(fitsio.HDU(data=np.asarray(sp.var, np.float64),
                                       header=vhdr))
        tables = dict(self.tables)
        if self.lines is not None:
            tables["LINES"] = self.lines
        for name, tbl in tables.items():
            hdr = fitsio.Header()
            hdr["EXTNAME"] = name if name == "LINES" else f"TAB_{name}"
            from collections import OrderedDict

            cols = OrderedDict(
                (k, np.asarray(tbl[k])) for k in tbl.colnames
            )
            hdus.append(fitsio.HDU(data=cols, header=hdr))
        fitsio.write(filename, hdus)

    @classmethod
    def from_file(cls, filename):
        from ..core.coords import WCS, WaveCoord

        hdus = fitsio.read(filename)
        src = cls(header=hdus[0].header)
        pending_stat = {}
        for h in hdus[1:]:
            name = h.name
            if name.startswith("IMA_"):
                wcs = WCS.from_header(h.header, shape=h.data.shape)
                src.images[name[4:]] = Image(data=h.data, wcs=wcs, copy=False)
            elif name.startswith("CUB_") and name.endswith("_DATA"):
                wcs = WCS.from_header(h.header, shape=h.data.shape[1:])
                wave = WaveCoord.from_header(h.header, axis=3,
                                             shape=h.data.shape[0])
                src.cubes[name[4:-5]] = Cube(data=h.data, wcs=wcs, wave=wave,
                                             copy=False)
            elif name.startswith("CUB_") and name.endswith("_STAT"):
                key = name[4:-5]
                if key in src.cubes:
                    src.cubes[key].var = h.data
            elif name.startswith("SPE_") and name.endswith("_DATA"):
                wave = WaveCoord.from_header(h.header, axis=1,
                                             shape=h.data.shape[0])
                src.spectra[name[4:-5]] = Spectrum(data=h.data, wave=wave,
                                                   copy=False)
            elif name.startswith("SPE_") and name.endswith("_STAT"):
                key = name[4:-5]
                if key in src.spectra:
                    src.spectra[key].var = h.data
            elif name == "LINES":
                t = Table()
                for k, v in h.data.items():
                    t[k] = v
                src.lines = t
            elif name.startswith("TAB_"):
                t = Table()
                for k, v in h.data.items():
                    t[k] = v
                src.tables[name[4:]] = t
        return src
