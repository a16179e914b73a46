"""Standardization, O2 statistics and Gaussian-fit thresholds.

Torch port of :mod:`origin_tpu.ops.stats`: the per-voxel math
(standardize, O2 test) runs on the session's device; the tiny statistical
fits (sigma clipping, histogram Gaussian fit) are the same numpy code.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy import stats as sstats
from scipy.optimize import curve_fit

__all__ = [
    "o2test",
    "standardize",
    "sigma_clip",
    "compute_thresh_gaussfit",
]

FWHM_TO_SIGMA = 1.0 / (2.0 * np.sqrt(2.0 * np.log(2.0)))
SIGMA_TO_FWHM = 2.0 * np.sqrt(2.0 * np.log(2.0))


def o2test(arr):
    """Second-order statistic per spaxel: mean over z of the squares."""
    return torch.mean(arr * arr, dim=0)


def standardize(cube_raw, cont, var, mask, with_mean=False):
    """Continuum-subtracted, mean-removed, noise-whitened cube.

    Same math as :func:`origin_tpu.ops.stats.standardize`::

        data = raw - cont                 (masked voxels excluded)
        data -= nanmean(data, axis=(1,2))  (per-channel background level)
        data /= sqrt(var);  data[mask] = 0
        cont_std = cont / sqrt(var)

    Returns (cube_std, cont_std); with ``with_mean``, also the (Nz,)
    per-channel background levels.
    """
    good = ~mask
    data = cube_raw - cont
    ngood = torch.clamp(good.sum(dim=(1, 2)), min=1)
    mean_z = torch.where(good, data, 0.0).sum(dim=(1, 2)) / ngood
    std = torch.sqrt(var)
    data = (data - mean_z[:, None, None]) / std
    data = torch.where(good & torch.isfinite(data), data, 0.0)
    cont_std = cont / std
    cont_std = torch.where(torch.isfinite(cont_std), cont_std, 0.0)
    if with_mean:
        return data, cont_std, mean_z
    return data, cont_std


def sigma_clip(data, sigma=10.0, maxiters=5):
    """Iterative sigma clipping around the median (host, numpy)."""
    data = np.asarray(data, dtype=float).ravel()
    data = data[np.isfinite(data)]
    for _ in range(maxiters):
        med = np.median(data)
        std = np.std(data)
        keep = np.abs(data - med) <= sigma * std
        if keep.all():
            break
        data = data[keep]
    return data


def compute_thresh_gaussfit(data, pfa, bins="fd", sigclip=10):
    """Detection threshold from a Gaussian fit of the noise distribution.

    Clip the positive test values, histogram them, estimate the mode and
    width from the histogram shape, refine with a least-squares Gaussian
    fit of the left flank, then ``threshold = mean - std * Phi^-1(pfa)``.

    Returns (histO2, frecO2, thresO2, mea, std).
    """
    data = np.asarray(data, dtype=float)
    data = data[data > 0]
    data = sigma_clip(data, sigma=sigclip)
    hist, edges = np.histogram(data, bins=bins, density=True)
    imax = int(np.argmax(hist))
    mode = edges[imax]
    ihalf = int(np.argmin((hist[imax] / 2.0 - hist[:imax]) ** 2)) if imax > 0 else 0
    fwhm = mode - edges[ihalf]
    sigma = fwhm / np.sqrt(2 * np.log(2))
    coef = sstats.norm.ppf(pfa)

    centers = 0.5 * (edges[1:] + edges[:-1])
    xcut = mode + SIGMA_TO_FWHM * sigma / 2.0
    ksel = centers < xcut

    def gauss(x, amp, mu, sig):
        return amp * np.exp(-0.5 * ((x - mu) / sig) ** 2)

    mea, std = mode, sigma
    if ksel.sum() >= 3:
        try:
            popt, _ = curve_fit(
                gauss,
                centers[ksel],
                hist[ksel],
                p0=[hist.max(), mode, abs(sigma) or 1.0],
                maxfev=10000,
            )
            mea, std = float(popt[1]), float(abs(popt[2]))
        except (RuntimeError, ValueError):
            pass

    thres = float(mea - std * coef)
    return hist, edges, thres, float(mea), float(std)
