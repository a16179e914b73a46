"""Spectral line-profile dictionaries.

(The port's copy of ``origin_tpu/core/profiles.py``, unchanged apart from this note.)

The reference ships two FITS dictionaries of L2-normalized Gaussian line
profiles (muse_origin/Dico_3FWHM.fits and Dico_FWHM_2_12.fits; structure
verified against origin.py:515-533: one IMAGE extension per profile, 201
samples, FWHM in the header).  We regenerate them from the formula:

    sigma = FWHM / (2 sqrt(2 ln 2));  p = exp(-(k-100)^2 / 2 sigma^2);
    p /= ||p||_2

with FWHM values linspace(2, 12, 20) (the 3-profile dictionary uses indices
0, 9, 19 of that grid).
"""

from __future__ import annotations

import os

import numpy as np

from .. import fitsio

__all__ = [
    "gaussian_profile",
    "make_profiles",
    "write_dictionary",
    "load_dictionary",
    "default_dictionary_path",
    "DICO_3FWHM",
    "DICO_FWHM_2_12",
]

N_SAMPLES = 201
CENTER = 100
FWHM_GRID = np.linspace(2.0, 12.0, 20)

DICO_3FWHM = "Dico_3FWHM.fits"
DICO_FWHM_2_12 = "Dico_FWHM_2_12.fits"

_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "data")


def gaussian_profile(fwhm, n=N_SAMPLES, center=CENTER):
    """L2-normalized Gaussian line profile."""
    sigma = fwhm / (2.0 * np.sqrt(2.0 * np.log(2.0)))
    x = np.arange(n, dtype=float)
    p = np.exp(-0.5 * ((x - center) / sigma) ** 2)
    return p / np.linalg.norm(p)


def make_profiles(fwhms, n=N_SAMPLES):
    """List of (profile, fwhm) pairs."""
    return [(gaussian_profile(f, n), float(f)) for f in np.atleast_1d(fwhms)]


def write_dictionary(filename, fwhms, indices=None, n=N_SAMPLES):
    """Write a profile dictionary FITS file (one extension per profile)."""
    fwhms = np.atleast_1d(fwhms)
    if indices is None:
        indices = range(len(fwhms))
    hdus = [fitsio.HDU()]
    for idx, fwhm in zip(indices, fwhms):
        hdr = fitsio.Header()
        hdr["EXTNAME"] = f"PROF{idx:02d}", "extension name"
        hdr["FWHM"] = float(fwhm), "FWHM in pixels"
        hdus.append(fitsio.HDU(data=gaussian_profile(fwhm, n), header=hdr))
    fitsio.write(filename, hdus)


def load_dictionary(filename):
    """Load a profile dictionary. Returns (profiles, fwhms).

    Accepts a path or a built-in dictionary name (``DICO_3FWHM`` /
    ``DICO_FWHM_2_12``), which is generated on first use.
    """
    if filename in (DICO_3FWHM, DICO_FWHM_2_12) and not os.path.exists(
        filename
    ):
        filename = default_dictionary_path(filename)
    hdus = fitsio.read(filename)
    profiles, fwhms = [], []
    for h in hdus[1:]:
        if h.data is None:
            continue
        profiles.append(np.asarray(h.data, dtype=float))
        fwhms.append(float(h.header["FWHM"]))
    if len({p.shape[0] for p in profiles}) != 1:
        raise ValueError("The profiles must have the same size")
    return profiles, fwhms


def default_dictionary_path(name=DICO_3FWHM):
    """Path of a built-in dictionary, generating the file if needed."""
    os.makedirs(_DATA_DIR, exist_ok=True)
    path = os.path.join(_DATA_DIR, name)
    if not os.path.exists(path):
        if name == DICO_3FWHM:
            write_dictionary(path, FWHM_GRID[[0, 9, 19]], indices=[0, 9, 19])
        elif name == DICO_FWHM_2_12:
            write_dictionary(path, FWHM_GRID)
        else:
            raise ValueError(f"unknown built-in dictionary {name!r}")
    return path
