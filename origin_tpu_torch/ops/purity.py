"""Self-calibrated purity threshold estimation (torch port of
:mod:`origin_tpu.ops.purity`).

The per-threshold detection counts over the local-max / local-min cubes
run on the session's device; the tiny interpolation stays on the host.
A mesh session's cubes are row shards (``parallel.mesh.RowShards``),
which take ``max``, ``amax`` over z and the product with an (Ny, Nx) map
as tensors do and count their own tiles (:func:`_counts`): the counts are
summed integers and the grid's ends are exact maxima, so they are the
single device's.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from .. import tracing
from ..core.table import Table
from ..device import resolve_device

__all__ = [
    "counts_above_thresholds",
    "compute_threshold_purity",
    "compute_threshold_purity_pair",
]

NTHRESH = 50  # linspace over 50 thresholds

logger = logging.getLogger(__name__)


def counts_above_thresholds(values, thresholds):
    """count(values > t) for every t of the threshold vector (int64).

    One compare-and-count pass per threshold: a broadcast over the whole
    grid would hold ``len(thresholds)`` cube-sized masks at once.
    """
    v = values.reshape(-1)
    return torch.stack([torch.count_nonzero(v > t) for t in thresholds])


def _counts(values, thresholds):
    """:func:`counts_above_thresholds` of a tensor, or the counts of row
    shards summed over their tiles."""
    if torch.is_tensor(values):
        return counts_above_thresholds(values, thresholds)
    return values.counts_above(thresholds)


def _median(x):
    """Median with ``jnp.median``'s even-count rule: the mean of the two
    middle values, ``(lo + hi) * 0.5`` in the input dtype
    (``torch.median`` would return the lower one)."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _purity_stats(cmax, cmin):
    """The auto grid's statistics of one cube pair, float32 scalars on its
    device: the max of the local minima, the max of the local maxima and
    the median over spaxels of the local maxima's max along z."""
    return cmin.max(), cmax.max(), _median(cmax.amax(dim=0))


def _scan_auto(cmax, cmin):
    """Auto threshold grid + both count scans for one cube pair."""
    maxmin, maxmax, med = _purity_stats(cmax, cmin)
    tmax = torch.minimum(maxmin, maxmax)
    tmin = med * 1.1
    # tmin + (tmax - tmin) * (i / 49), as the JAX package's compiled
    # program evaluates it: XLA folds the division into a float32
    # reciprocal, reassociates, and contracts i * step + tmin into an FMA
    # (emulated exactly here through float64)
    step = (tmax - tmin) * torch.tensor(1.0 / (NTHRESH - 1),
                                        dtype=torch.float32)
    i = torch.arange(NTHRESH, dtype=torch.float64, device=cmax.device)
    th = (i * step.double() + tmin.double()).to(cmax.dtype)
    # pin the endpoint exactly to tmax (float32 rounding can land the last
    # grid point strictly below it, which would count the cube maximum into
    # n_min at the top of the grid and collapse the purity curve to a
    # spurious "unreachable" -> threshold = inf)
    th[-1] = tmax
    return th, _counts(cmax, th), _counts(cmin, th)


def _fused_pair_auto(clmax, clmin, segmask, cslmax, cslmin):
    """Step 06's device math: segmap masking of the correl local-min cube,
    both auto threshold grids and all four count scans.  Returns six
    (NTHRESH,) vectors."""
    clmin = clmin * segmask
    return _scan_auto(clmax, clmin) + _scan_auto(cslmax, cslmin)


def _fused_pair_given(clmax, clmin, segmask, cslmax, cslmin, th):
    clmin = clmin * segmask
    return (
        _counts(clmax, th),
        _counts(clmin, th),
        _counts(cslmax, th),
        _counts(cslmin, th),
    )


def _purity_table(purity, threshlist, n1, n0, l0, l1):
    """Host tail: purity curve, Pval table, interpolated threshold."""
    n1 = np.asarray(n1).astype(float)
    n0 = np.asarray(n0).astype(float)

    n0 = n0 * (l1 / l0)
    with np.errstate(divide="ignore", invalid="ignore"):
        est_purity = 1.0 - n0 / n1

    res = Table(
        data=[np.asarray(threshlist, float), est_purity,
              n0.astype(int), n1.astype(int)],
        names=("Tval_r", "Pval_r", "Det_m", "Det_M"),
    )
    res.set_format("Tval_r", ".2f")
    res.set_format("Pval_r", ".2f")

    if est_purity[-1] < purity:
        logger.warning(
            "Maximum computed purity %.2f is below %.2f", est_purity[-1], purity
        )
        threshold = np.inf
    else:
        threshold = float(np.interp(purity, res["Pval_r"], res["Tval_r"]))
        detect = float(np.interp(threshold, res["Tval_r"], res["Det_M"]))
        logger.info(
            "Interpolated Threshold %.2f Detection %d for Purity %.2f",
            threshold,
            detect,
            purity,
        )
    return float(threshold), res


def _host(vectors):
    return [v.cpu().numpy() for v in vectors]


def compute_threshold_purity(
    purity, cube_local_max, cube_local_min, segmap=None, threshlist=None,
    device="cuda",
):
    """Estimate the detection threshold achieving a target purity for one
    cube pair (the reference's ``Compute_threshold_purity``).

    The false-detection rate is self-calibrated from the data: local minima
    of the negated cube behave like noise-only detections, so

        purity(t) = 1 - n_min(t) * (L1/L0) / n_max(t)

    with L0 the number of calibration spaxels (the background, ``segmap ==
    0``, if a segmap is given) and L1 the total.  Tensors stay on their
    device; numpy cubes go to ``device`` (``"cuda"`` raises without a
    GPU).  As in the JAX package, the auto grid is the float64
    ``linspace`` between the three statistics read back to the host, not
    the float32 grid of :func:`compute_threshold_purity_pair`.

    Returns (threshold, Table[Tval_r, Pval_r, Det_m, Det_M]).
    """
    def on_device(cube):
        if torch.is_tensor(cube):
            return cube
        return torch.as_tensor(np.asarray(cube, np.float32),
                               device=resolve_device(device))

    cube_local_max = on_device(cube_local_max)
    cube_local_min = on_device(cube_local_min)
    dev = cube_local_min.device
    l1 = float(np.prod(cube_local_min.shape[1:]))
    if segmap is not None:
        segmask = np.asarray(segmap) == 0
        # the float32 product: NaN x 0 stays NaN
        cube_local_min = cube_local_min * torch.as_tensor(
            segmask, dtype=torch.float32, device=dev)
        l0 = float(np.count_nonzero(segmask))
        logger.info("using only background pixels (%.1f%%)", l0 / l1 * 100)
    else:
        l0 = l1

    if threshlist is None:
        maxmin, maxmax, med = (float(v) for v in _purity_stats(
            cube_local_max, cube_local_min))
        threshlist = np.linspace(med * 1.1, min(maxmin, maxmax), NTHRESH)
    else:
        threshlist = np.sort(np.asarray(threshlist, dtype=float))

    th = torch.as_tensor(threshlist, dtype=torch.float32, device=dev)
    n1, n0 = _host((_counts(cube_local_max, th),
                    _counts(cube_local_min, th)))
    return _purity_table(purity, threshlist, n1, n0, l0, l1)


def compute_threshold_purity_pair(
    purity,
    cube_local_max,
    cube_local_min,
    cube_std_local_max,
    cube_std_local_min,
    segmap,
    *,
    purity_std=None,
    threshlist=None,
):
    """Both of step 06's purity scans (correl pair with background-segmap
    masking, std pair without) on the cubes' device.

    Returns (threshold, Pval, threshold_std, Pval_comp).
    """
    if purity_std is None:
        purity_std = purity
    dev = cube_local_max.device
    l1 = float(np.prod(cube_local_min.shape[1:]))
    segmask = np.asarray(segmap) == 0
    l0 = float(np.count_nonzero(segmask))
    logger.info("using only background pixels (%.1f%%)", l0 / l1 * 100)
    with tracing.span("purity.counts"):
        segmask = torch.as_tensor(segmask, dtype=torch.float32, device=dev)
        if threshlist is None:
            th_c, n1_c, n0_c, th_s, n1_s, n0_s = _host(_fused_pair_auto(
                cube_local_max, cube_local_min, segmask,
                cube_std_local_max, cube_std_local_min,
            ))
            th_c, th_s = np.asarray(th_c, float), np.asarray(th_s, float)
        else:
            th_c = th_s = np.sort(np.asarray(threshlist, dtype=float))
            th = torch.as_tensor(th_c, dtype=torch.float32, device=dev)
            n1_c, n0_c, n1_s, n0_s = _host(_fused_pair_given(
                cube_local_max, cube_local_min, segmask,
                cube_std_local_max, cube_std_local_min, th,
            ))

    threshold, pval = _purity_table(purity, th_c, n1_c, n0_c, l0, l1)
    threshold_std, pval_comp = _purity_table(
        purity_std, th_s, n1_s, n0_s, l1, l1
    )
    return threshold, pval, threshold_std, pval_comp
