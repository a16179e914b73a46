"""Cube files with the non-finite patterns of the staged white image's
tests, shared by tests/test_torch_ingest.py (CPU) and
tests/test_torch_gpu.py (CUDA).  Imports nothing of JAX.

Each file is the port's minicube at a small size, its NaN voxels made
finite, and then one pattern put in the DATA payload (the STAT payload is
left finite): none, scattered NaN voxels, one +inf and one -inf voxel, one
all-NaN spaxel, or a NaN border of whole columns.  The payloads are
written as they are, so the infinities reach the file.
"""

import numpy as np

from origin_tpu_torch import fitsio
from tools_torch.synthetic import make_minicube

PATTERNS = ("finite", "nan_voxels", "inf_voxel", "nan_spaxel", "nan_border")


def _apply(data, pattern, rng):
    """``data`` with ``pattern`` put in, in place."""
    nz, ny, nx = data.shape
    if pattern == "nan_voxels":
        data.ravel()[rng.integers(0, data.size, size=40)] = np.nan
        data[:5, 2, 3] = np.nan  # several in one spaxel
    elif pattern == "inf_voxel":
        data[nz // 2, 1, 2] = np.inf
        data[3, ny - 2, nx - 1] = -np.inf
    elif pattern == "nan_spaxel":
        data[:, 4, 6] = np.nan
        data[7, 5, 6] = np.nan
    elif pattern == "nan_border":
        data[:, :, :2] = np.nan
        data[:, :, -1] = np.nan
    elif pattern != "finite":
        raise ValueError(pattern)
    return data


def write_pattern(path, pattern, bitpix=-32, nz=120, ny=24, nx=20):
    """Writes the cube file of ``pattern`` to ``path``; returns ``path``."""
    src = make_minicube(None, nz=nz, ny=ny, nx=nx)
    rng = np.random.default_rng(11)
    data = np.where(np.isfinite(src.data), src.data, 0.0)
    var = np.where(np.isfinite(src.var), src.var, 1.0)
    data = _apply(data.astype(np.float64), pattern, rng)
    dtype = np.float32 if bitpix == -32 else np.float64
    hdr = src._data_header()
    stat = hdr.copy()
    stat["EXTNAME"] = "STAT"
    fitsio.write(path, [
        fitsio.HDU(header=src.primary_header.copy()),
        fitsio.HDU(data=data.astype(dtype), header=hdr),
        fitsio.HDU(data=var.astype(dtype), header=stat),
    ])
    return path


def finite_mean(data):
    """The (Ny, Nx) float64 mean of each spaxel's finite values, NaN where
    it has none, and the count of those values."""
    d = np.asarray(data, np.float64)
    fin = np.isfinite(d)
    count = fin.sum(axis=0)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(fin, d, 0.0).sum(axis=0) / count, count


def check_white(white, host, data):
    """Holds the staged route's white image ``white`` to the host route's
    ``host`` (``Cube.mean(axis=0)``) and to the float64 mean of ``data``'s
    finite values: the same mask bit for bit, and data within 2 float32
    ulp of the float64 mean and within the host's own float32 error (plus
    those 2 ulp) of the host's."""
    assert isinstance(white.data, np.ndarray)
    assert white.data.dtype == host.data.dtype == np.float32
    if host.mask is None:
        assert white.mask is None
    else:
        np.testing.assert_array_equal(white.mask, host.mask)
    np.testing.assert_array_equal(np.isnan(white.data), np.isnan(host.data))
    ref, _ = finite_mean(data)
    ok = np.isfinite(ref)
    ulp = np.spacing(np.abs(ref[ok]).astype(np.float32)).astype(np.float64)
    w = white.data[ok].astype(np.float64)
    h = host.data[ok].astype(np.float64)
    assert np.all(np.abs(w - ref[ok]) <= 2 * ulp)
    assert np.all(np.abs(w - h) <= np.abs(h - ref[ok]) + 2 * ulp)


def check_cube_mask(cube, data):
    """The host cube's mask is ``~isfinite(data)`` bit for bit, None when
    every value is finite, and served by the stamp."""
    bad = ~np.isfinite(np.asarray(data))
    if not bad.any():
        assert cube.mask is None
    else:
        np.testing.assert_array_equal(cube.mask, bad)
    np.testing.assert_array_equal(cube.masked_invalid(), bad)
    assert cube._mask_is_nonfinite


def flagged_spaxels(data):
    """How many spaxels hold a non-finite value."""
    return int((~np.isfinite(np.asarray(data))).any(axis=0).sum())
