"""Field spread function (FSF) models and mosaic field maps.

(The port's copy of ``origin_tpu/core/fsf.py``, with
:func:`read_field_fsf`, :func:`field_weights` and :func:`combine_fsf`
added: the FSF of one source of a multi-field session, which the JAX
package's step 11 lacks.)

Replaces the subset of ``mpdaf.MUSE.FSFModel`` / ``mpdaf.MUSE.FieldsMap`` used
by the reference (origin.py:579-649): a circular Moffat FSF whose FWHM and
beta are polynomials of wavelength, serialized in FITS headers with the
MUSE "FSFMODE 2" convention:

    FSFMODE = 2
    FSFLB1, FSFLB2                  reference wavelengths (Angstrom)
    FSF<ff>FNC, FSF<ff>F00..        FWHM polynomial coefficients (arcsec),
                                    evaluated with np.polyval on the reduced
                                    wavelength (lbda - LB1) / (LB2 - LB1)
    FSF<ff>BNC, FSF<ff>B00..        beta polynomial coefficients

``get_3darray`` reconstructs the (Nz, size, size) PSF cube used by the GLR
matched filter (reference origin.py:590-605).
"""

from __future__ import annotations

import numpy as np

from ..fitsio import Header

__all__ = ["MoffatFSF", "read_fsf_from_header", "FieldsMap", "moffat_image",
           "read_field_fsf", "field_weights", "combine_fsf", "SOURCE_FIELD"]

#: the field index under which a source file records its own FSF, the
#: fields' models combined at the source (:func:`combine_fsf`)
SOURCE_FIELD = 99


def moffat_image(fwhm_pix, beta, shape):
    """Circular Moffat profile image, unit total (analytic) flux.

    I(r) = (beta-1)/(pi alpha^2) * (1 + (r/alpha)^2)^(-beta)
    with alpha = fwhm / (2 sqrt(2^(1/beta) - 1)).
    """
    ny, nx = shape
    cy, cx = (ny - 1) / 2.0, (nx - 1) / 2.0
    y, x = np.mgrid[:ny, :nx]
    r2 = (y - cy) ** 2 + (x - cx) ** 2
    alpha = fwhm_pix / (2.0 * np.sqrt(2.0 ** (1.0 / beta) - 1.0))
    return (beta - 1.0) / (np.pi * alpha ** 2) * (1.0 + r2 / alpha ** 2) ** (-beta)


class MoffatFSF:
    """Circular Moffat FSF with wavelength-dependent FWHM and beta."""

    def __init__(self, fwhm_pol, beta_pol, lbrange=(5000.0, 9000.0), pixstep=0.2,
                 field=0):
        # polynomial coefficients in np.polyval order (highest degree first)
        self.fwhm_pol = list(np.atleast_1d(fwhm_pol).astype(float))
        self.beta_pol = list(np.atleast_1d(beta_pol).astype(float))
        self.lbrange = tuple(lbrange)
        self.pixstep = float(pixstep)  # arcsec / pixel
        self.field = field

    def _reduced(self, lbda):
        lb1, lb2 = self.lbrange
        return (np.asarray(lbda, dtype=float) - lb1) / (lb2 - lb1)

    def get_fwhm(self, lbda, unit="arcsec"):
        fwhm = np.polyval(self.fwhm_pol, self._reduced(lbda))
        if unit in ("pix", "pixel"):
            fwhm = fwhm / self.pixstep
        return fwhm

    def get_beta(self, lbda):
        return np.polyval(self.beta_pol, self._reduced(lbda))

    def get_2darray(self, lbda, shape):
        return moffat_image(
            float(self.get_fwhm(lbda, unit="pix")), float(self.get_beta(lbda)), shape
        )

    def get_3darray(self, lbda, shape):
        lbda = np.atleast_1d(lbda)
        fwhm = np.atleast_1d(self.get_fwhm(lbda, unit="pix"))
        beta = np.atleast_1d(self.get_beta(lbda))
        ny, nx = shape
        cy, cx = (ny - 1) / 2.0, (nx - 1) / 2.0
        y, x = np.mgrid[:ny, :nx]
        r2 = (y - cy) ** 2 + (x - cx) ** 2
        alpha = fwhm / (2.0 * np.sqrt(2.0 ** (1.0 / beta) - 1.0))
        out = (beta - 1.0)[:, None, None] / (np.pi * alpha ** 2)[:, None, None] * (
            1.0 + r2[None] / (alpha ** 2)[:, None, None]
        ) ** (-beta[:, None, None])
        return out

    def to_header(self, hdr=None):
        hdr = hdr if hdr is not None else Header()
        ff = self.field
        hdr["FSFMODE"] = 2, "Circular MOFFAT beta=poly(lbda) fwhm=poly(lbda)"
        hdr["FSFLB1"] = self.lbrange[0], "FSF Blue Ref Wave (A)"
        hdr["FSFLB2"] = self.lbrange[1], "FSF Red Ref Wave (A)"
        hdr[f"FSF{ff:02d}FNC"] = len(self.fwhm_pol), f"FSF{ff:02d} FWHM Poly Ncoef"
        for i, c in enumerate(self.fwhm_pol):
            hdr[f"FSF{ff:02d}F{i:02d}"] = float(c), f"FSF{ff:02d} FWHM Poly C{i:02d}"
        hdr[f"FSF{ff:02d}BNC"] = len(self.beta_pol), f"FSF{ff:02d} BETA Poly Ncoef"
        for i, c in enumerate(self.beta_pol):
            hdr[f"FSF{ff:02d}B{i:02d}"] = float(c), f"FSF{ff:02d} BETA Poly C{i:02d}"
        return hdr


def read_field_fsf(hdr, field, pixstep=0.2):
    """The FSF model of one field of a FITS header (KeyError if the header
    lacks it)."""
    key = f"FSF{field:02d}"
    fwhm_pol = [float(hdr[f"{key}F{i:02d}"])
                for i in range(int(hdr[f"{key}FNC"]))]
    beta_pol = [float(hdr[f"{key}B{i:02d}"])
                for i in range(int(hdr[f"{key}BNC"]))]
    lbrange = (float(hdr.get("FSFLB1", 5000.0)), float(hdr.get("FSFLB2", 9000.0)))
    return MoffatFSF(fwhm_pol, beta_pol, lbrange=lbrange, pixstep=pixstep,
                     field=field)


def read_fsf_from_header(hdr, pixstep=0.2):
    """Read FSF model(s) from a FITS header.

    Returns a single MoffatFSF if only field 00 is present, else a list of
    models (one per field).  Raises ValueError if no FSF keywords are found.
    """
    if "FSFMODE" not in hdr:
        raise ValueError("missing FSF keywords in the cube FITS header")
    models = []
    for ff in range(100):
        key = f"FSF{ff:02d}FNC"
        if key not in hdr:
            if ff == 0:
                continue
            break
        models.append(read_field_fsf(hdr, ff, pixstep))
    if not models:
        raise ValueError("FSFMODE present but no FSF coefficients found")
    return models[0] if len(models) == 1 else models


def field_weights(wfields, y, x):
    """The weight of each field at pixel (y, x), rounded to the nearest
    pixel of the field and clipped into it."""
    ny, nx = np.shape(wfields[0])
    yi = min(max(int(np.round(y)), 0), ny - 1)
    xi = min(max(int(np.round(x)), 0), nx - 1)
    return [float(np.asarray(w)[yi, xi]) for w in wfields]


def combine_fsf(models, weights):
    """One source's FSF in a multi-field session: the fields' FWHM and beta
    polynomials averaged with ``weights`` (the fields' weights at the
    source, :func:`field_weights`; equal weights where they sum to 0,
    as the session's mean FWHM takes them).  A weighted sum of
    polynomials is the polynomial of the weighted coefficients, padded to
    one degree, so the result is again a :class:`MoffatFSF`, recorded as
    field :data:`SOURCE_FIELD`.
    """
    w = np.asarray(weights, dtype=float)
    if len(w) != len(models):
        raise ValueError(f"{len(w)} weights for {len(models)} FSF models")
    w = w / w.sum() if w.sum() > 0 else np.full(len(w), 1.0 / len(w))

    def mean_pol(pols):
        deg = max(len(p) for p in pols)
        padded = np.array([[0.0] * (deg - len(p)) + list(p) for p in pols])
        return list(w @ padded)

    ref = models[0]
    return MoffatFSF(mean_pol([m.fwhm_pol for m in models]),
                     mean_pol([m.beta_pol for m in models]),
                     lbrange=ref.lbrange, pixstep=ref.pixstep,
                     field=SOURCE_FIELD)


class FieldsMap:
    """Mosaic field map: per-pixel field index (0 = no field, 1..N = fields).

    ``compute_weights`` returns one weight map per field.  The reference uses
    mpdaf's smoothed weights (origin.py:606-609); we use the normalized
    indicator maps, which have the same support and sum to 1 on covered
    pixels.
    """

    def __init__(self, filename=None, data=None, nfields=None):
        if data is None:
            from .. import fitsio

            data = fitsio.getdata(filename)
        self.data = np.asarray(data).astype(int)
        self.nfields = int(nfields if nfields is not None else self.data.max())

    def compute_weights(self):
        weights = []
        covered = self.data > 0
        for f in range(1, self.nfields + 1):
            w = (self.data == f).astype(float)
            weights.append(w)
        total = np.sum(weights, axis=0)
        total[total == 0] = 1.0
        return [w / total * covered for w in weights]
