"""Image segmentation utilities (host side).

Replaces the photutils calls of the reference (detect_sources,
deblend_sources, make_source_mask — see reference lib_origin.py:243-357 and
source_masks.py:111-115) plus `compute_segmap_gauss`.  These operate on small
2-D images, so they stay on host (numpy/scipy.ndimage).

The deblending here is a simplified multi-threshold watershed: markers are
the connected components at the highest level where a segment splits into
>= 2 components of >= npixels, and the remaining pixels are assigned by
constrained dilation in decreasing-flux order.  photutils additionally
applies a flux-contrast criterion with a default (0.001) that nearly always
passes; we document and omit it.
"""

from __future__ import annotations

import logging

import numpy as np
from scipy import ndimage as ndi
from scipy.signal import fftconvolve

from ..ops.stats import compute_thresh_gaussfit

__all__ = [
    "detect_sources",
    "deblend_sources",
    "make_source_mask",
    "sigma_clipped_stats",
    "compute_segmap_gauss",
    "compute_deblended_segmap",
]

logger = logging.getLogger(__name__)

_STRUCT8 = np.ones((3, 3), dtype=bool)


def detect_sources(data, threshold, npixels, mask=None, connectivity=8):
    """Segmentation image of sources above threshold with >= npixels pixels.

    Returns an int32 label array (labels 1..N) or None when nothing is
    detected (matching photutils 0.7+, relied on in reference
    source_masks.py:123-128).
    """
    data = np.asarray(data)
    seg = data > threshold
    if mask is not None:
        seg &= ~np.asarray(mask, dtype=bool)
    structure = _STRUCT8 if connectivity == 8 else None
    labels, nlab = ndi.label(seg, structure=structure)
    if nlab == 0:
        return None
    sizes = np.bincount(labels.ravel())
    good = np.where(sizes >= npixels)[0]
    good = good[good > 0]
    if len(good) == 0:
        return None
    remap = np.zeros(nlab + 1, dtype=np.int32)
    remap[good] = np.arange(1, len(good) + 1)
    return remap[labels]


def _watershed_assign(data, region, markers):
    """Assign every pixel of `region` to a marker by constrained dilation,
    flooding from bright to faint."""
    out = markers.copy()
    unassigned = region & (out == 0)
    while unassigned.any():
        grown = False
        # expand each label by one 8-connected ring, brighter pixels first
        boundary = unassigned & ndi.binary_dilation(out > 0, structure=_STRUCT8)
        if not boundary.any():
            # disconnected leftovers: nearest assigned pixel
            idx = ndi.distance_transform_edt(
                out == 0, return_distances=False, return_indices=True
            )
            out[unassigned] = out[idx[0][unassigned], idx[1][unassigned]]
            break
        ys, xs = np.where(boundary)
        order = np.argsort(data[ys, xs])[::-1]
        for y, x in zip(ys[order], xs[order]):
            neigh = out[max(0, y - 1) : y + 2, max(0, x - 1) : x + 2]
            labs = neigh[neigh > 0]
            if len(labs):
                out[y, x] = labs[0]
                grown = True
        if not grown:
            break
        unassigned = region & (out == 0)
    return out


def deblend_sources(data, segmap, npixels=5, mode="linear", nlevels=32,
                    contrast=0.001, filter_kernel=None):
    """Deblend a segmentation image (simplified photutils.deblend_sources)."""
    data = np.asarray(data, dtype=float)
    segmap = np.asarray(segmap)
    out = np.zeros_like(segmap, dtype=np.int32)
    next_label = 1
    for lab in np.unique(segmap):
        if lab == 0:
            continue
        region = segmap == lab
        vals = data[region]
        vmin, vmax = float(vals.min()), float(vals.max())
        if mode == "exponential" and vmin > 0:
            levels = vmin * (vmax / vmin) ** (np.arange(1, nlevels + 1) / (nlevels + 1))
        else:
            levels = np.linspace(vmin, vmax, nlevels + 2)[1:-1]
        markers = None
        for level in levels[::-1]:
            comp, n = ndi.label(region & (data > level), structure=_STRUCT8)
            if n < 2:
                continue
            sizes = np.bincount(comp.ravel())
            good = np.where(sizes[1:] >= npixels)[0] + 1
            if len(good) >= 2:
                markers = np.where(np.isin(comp, good), comp, 0)
                break
        if markers is None:
            out[region] = next_label
            next_label += 1
        else:
            assigned = _watershed_assign(data, region, markers)
            for sublab in np.unique(assigned[assigned > 0]):
                out[region & (assigned == sublab)] = next_label
                next_label += 1
    return out


def sigma_clipped_stats(data, sigma=3.0, maxiters=5, mask=None):
    """(mean, median, std) of the sigma-clipped data."""
    data = np.asarray(data, dtype=float)
    if mask is not None:
        data = data[~np.asarray(mask, dtype=bool)]
    data = data[np.isfinite(data)]
    for _ in range(maxiters):
        med = np.median(data)
        std = np.std(data)
        keep = np.abs(data - med) <= sigma * std
        if keep.all():
            break
        data = data[keep]
    return float(np.mean(data)), float(np.median(data)), float(np.std(data))


def make_source_mask(data, snr=3.0, npixels=5, dilate_size=11, sigma=3.0,
                     maxiters=5):
    """Boolean mask of detected sources (photutils.make_source_mask subset)."""
    # photutils' detect_threshold builds the background from the
    # sigma-clipped MEAN (not the median)
    mean, median, std = sigma_clipped_stats(data, sigma=sigma, maxiters=maxiters)
    seg = detect_sources(data, mean + snr * std, npixels)
    if seg is None:
        return np.zeros(np.shape(data), dtype=bool)
    mask = seg > 0
    if dilate_size and dilate_size > 1:
        mask = ndi.binary_dilation(mask, np.ones((dilate_size, dilate_size), bool))
    return mask


def compute_segmap_gauss(data, pfa, fwhm_fsf=0, bins="fd"):
    """Threshold an image with Gaussian noise statistics and label it.

    Mirrors reference lib_origin.py:243-280: Gaussian-fit threshold, one
    erosion (border considered active) + one dilation to clean single-pixel
    detections, optional closing with a PSF-sized disc, then 4-connected
    labeling.

    Returns (threshold, label_image).
    """
    hist, bins_, gamma, mea, std = compute_thresh_gaussfit(data, pfa, bins=bins)
    mask = data > gamma
    mask = ndi.binary_erosion(mask, border_value=1, iterations=1)
    mask = ndi.binary_dilation(mask, iterations=1)
    if fwhm_fsf > 0:
        fwhm_pix = int(fwhm_fsf) // 2
        size = fwhm_pix * 2 + 1
        yy, xx = np.mgrid[:size, :size] - fwhm_pix
        disc = np.hypot(yy, xx) < fwhm_pix
        mask = fftconvolve(mask.astype(float), disc.astype(float), mode="same")
        mask = mask > 1e-9
    return gamma, ndi.label(mask)[0]


def compute_deblended_segmap(image, npixels=5, snr=3, dilate_size=11, maxiters=5,
                             sigma=3, fwhm=3.0, kernelsize=5):
    """Deblended segmentation map of an image (reference lib_origin.py:283-343).

    ``image`` may be an Image container or a plain array; returns the same
    kind.
    """
    from origin_tpu.core.containers import Image

    data = image.data if isinstance(image, Image) else np.asarray(image)
    mask = make_source_mask(data, snr=snr, npixels=npixels, dilate_size=dilate_size)
    _, bkg_median, bkg_rms = sigma_clipped_stats(
        data, sigma=sigma, mask=mask, maxiters=maxiters
    )
    threshold = bkg_median + sigma * bkg_rms
    logger.info(
        "Background Median %.2f RMS %.2f Threshold %.2f", bkg_median, bkg_rms,
        threshold,
    )
    # Gaussian smoothing before segmentation
    sig = fwhm / (2.0 * np.sqrt(2.0 * np.log(2.0)))
    k = np.arange(kernelsize) - kernelsize // 2
    g = np.exp(-0.5 * (k / sig) ** 2)
    kern = np.outer(g, g)
    kern /= kern.sum()
    smoothed = fftconvolve(data, kern, mode="same")
    segm = detect_sources(smoothed, threshold, npixels)
    if segm is None:
        segm = np.zeros(data.shape, dtype=np.int32)
    else:
        segm = deblend_sources(smoothed, segm, npixels=npixels, mode="linear")
    if isinstance(image, Image):
        return Image(data=segm, wcs=image.wcs, copy=False)
    return segm
