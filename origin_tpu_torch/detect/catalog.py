"""Catalog construction and cleaning operations.

Host-side reimplementation of reference lib_origin.py:1941-2222
(`purity_estimation`, `unique_sources`, `add_tglr_stat`,
`merge_similar_lines`) and the validation helper `compute_true_purity`
(lib_origin.py:2375-2443).
"""

from __future__ import annotations

from datetime import datetime

import numpy as np
from scipy.spatial import cKDTree

from ..core.table import Table, join

__all__ = [
    "purity_estimation",
    "unique_sources",
    "add_tglr_stat",
    "merge_similar_lines",
    "compute_true_purity",
]


def _interp_extrap(x, xp, fp):
    """Linear interpolation with linear extrapolation at both ends."""
    x = np.asarray(x, dtype=float)
    xp = np.asarray(xp, dtype=float)
    fp = np.asarray(fp, dtype=float)
    order = np.argsort(xp)
    xp, fp = xp[order], fp[order]
    out = np.interp(x, xp, fp)
    if len(xp) >= 2:
        lo = x < xp[0]
        hi = x > xp[-1]
        s0 = (fp[1] - fp[0]) / (xp[1] - xp[0]) if xp[1] != xp[0] else 0.0
        s1 = (fp[-1] - fp[-2]) / (xp[-1] - xp[-2]) if xp[-1] != xp[-2] else 0.0
        out[lo] = fp[0] + s0 * (x[lo] - xp[0])
        out[hi] = fp[-1] + s1 * (x[hi] - xp[-1])
    return out


def purity_estimation(cat, pval, pval_comp):
    """Per-line purity, interpolated from the threshold/purity tables.

    comp=0 lines use the correl table keyed on T_GLR, comp=1 lines the std
    table keyed on STD; results are clipped to [0, 1].
    (Reference lib_origin.py:1941-1991.)
    """
    purity = np.zeros(len(cat))
    comp = np.asarray(cat["comp"])

    sel = comp == 0
    if np.count_nonzero(sel) > 0:
        purity[sel] = _interp_extrap(
            np.asarray(cat["T_GLR"])[sel], pval["Tval_r"], pval["Pval_r"]
        )
    sel = comp == 1
    if np.count_nonzero(sel) > 0:
        purity[sel] = _interp_extrap(
            np.asarray(cat["STD"])[sel], pval_comp["Tval_r"], pval_comp["Pval_r"]
        )
    cat["purity"] = np.clip(purity, 0, 1)
    cat.set_format("purity", ".3f")
    return cat


def unique_sources(table):
    """Table of unique sources: flux-weighted mean positions per ID.

    Columns produced: ID, ra, dec, x, y, n_lines, seg_label, comp,
    line_merged_flag, waves.  (Reference lib_origin.py:1994-2091.)
    """
    rows = []
    grouped = table.group_by("ID")
    for group in grouped.groups:
        gid = int(group["ID"][0])
        flux = np.asarray(group["flux"], dtype=float)
        # failed line estimations carry NaN flux; a NaN weight would
        # poison the whole source's position, so they get weight 0 (and
        # uniform weights when every line of the source failed)
        w = np.where(np.isfinite(flux), flux, 0.0)
        if not w.any():
            w = np.ones_like(w)
        ra = np.average(np.asarray(group["ra"]), weights=w)
        dec = np.average(np.asarray(group["dec"]), weights=w)
        x = np.average(np.asarray(group["x"]), weights=w)
        y = np.average(np.asarray(group["y"]), weights=w)
        unmerged = np.asarray(group["merged_in"]) == -9999
        n_lines = int(np.sum(unmerged))
        seg_label = group["seg_label"][0]
        comp = group["comp"][0]
        flag = bool(np.any(np.asarray(group["line_merged_flag"])))
        sub = group[unmerged]
        order = np.argsort(np.asarray(sub["flux"]))
        lbdas = np.asarray(sub["lbda"])[order]
        waves = ",".join(str(int(l)) for l in lbdas[:-4:-1])
        rows.append([gid, ra, dec, x, y, n_lines, seg_label, comp, flag, waves])
    out = Table(
        rows=rows,
        names=["ID", "ra", "dec", "x", "y", "n_lines", "seg_label", "comp",
               "line_merged_flag", "waves"],
    )
    if "CAT3_TS" in table.meta:
        out.meta["CAT3_TS"] = table.meta["CAT3_TS"]
    return out


def add_tglr_stat(src_table, lines_table, correl, std):
    """Add nsigTGLR/nsigSTD to the line table; join per-source maxima.

    ``correl`` / ``std`` are the correlation and standardized cubes, or
    (to avoid pulling device-resident cubes to host) their precomputed
    standard-deviation scalars.  (Reference lib_origin.py:2094-2137.)
    """
    std_correl = float(correl) if np.ndim(correl) == 0 else float(np.std(correl))
    lines_table["nsigTGLR"] = np.asarray(lines_table["T_GLR"]) / std_correl
    std_std = float(std) if np.ndim(std) == 0 else float(np.std(std))
    lines_table["nsigSTD"] = np.asarray(lines_table["STD"]) / std_std

    cols = ["ID", "flux", "STD", "nsigSTD", "T_GLR", "nsigTGLR", "purity"]
    lines = lines_table[cols]
    agg = lines.group_by("ID").groups.aggregate(np.nanmax)
    return join(src_table, agg, key="ID")


def merge_similar_lines(table, *, z_pix_threshold=5):
    """Flag chains of near-identical lines of a source as merged.

    Within each ID, lines sorted by z are chained when consecutive gaps are
    below the threshold; all but the brightest of a chain are marked
    ``merged_in`` the brightest line's num_line.  Adds ``line_merged_flag``
    and ``merged_in`` columns and a CAT3_TS timestamp.
    (Reference lib_origin.py:2140-2222.)
    """
    table = table.copy()
    n = len(table)
    idx_to_flag = []
    merged_in = np.full(n, -9999, dtype=int)

    ids = np.asarray(table["ID"])
    zs = np.asarray(table["z"])
    nums = np.asarray(table["num_line"])
    fluxes = np.asarray(table["flux"])

    for gid in np.unique(ids):
        rows = np.where(ids == gid)[0]
        if len(rows) == 1:
            continue
        rows = rows[np.argsort(zs[rows])]
        gaps = np.diff(zs[rows])
        chain_id = np.concatenate([[0], np.cumsum(gaps >= z_pix_threshold)])
        for c in np.unique(chain_id):
            sub = rows[chain_id == c]
            if len(sub) <= 1:
                continue
            sub = sub[np.argsort(fluxes[sub])]
            idx_to_flag.extend(sub.tolist())
            brightest = sub[-1]
            merged_in[sub[:-1]] = nums[brightest]

    flag = np.zeros(n, dtype=bool)
    flag[idx_to_flag] = True
    table["line_merged_flag"] = flag
    table["merged_in"] = merged_in
    table.sort(["ID", "z"])
    table.meta["CAT3_TS"] = datetime.now().isoformat()
    return table


def compute_true_purity(cube_local_max, refcat, wave=None, maxdist=4.5,
                        threshmin=4, threshmax=7, plot=False, pval=None,
                        ax=None):
    """Purity/completeness against a reference catalog (validation harness).

    ``refcat`` is a Table (or path) with columns TYPE, Q, P, LOBS; lines have
    TYPE == 6.  ``cube_local_max`` may be a Cube container (with .wave) or a
    plain array plus an explicit ``wave`` coordinate.
    (Reference lib_origin.py:2375-2443.)
    """
    if isinstance(refcat, str):
        refcat = Table.read(refcat)
    reflines = refcat[np.asarray(refcat["TYPE"]) == 6]
    data = getattr(cube_local_max, "data", cube_local_max)
    wave = wave if wave is not None else cube_local_max.wave
    zref = wave.pixel(np.asarray(reflines["LOBS"]))
    kdref = cKDTree(np.array([reflines["Q"], reflines["P"], zref]).T)
    nref = len(refcat)

    zM, yM, xM = np.where(np.asarray(data) > threshmin)
    tglr = np.asarray(data)[zM, yM, xM]

    res = []
    for thr in np.arange(threshmin, threshmax, 0.1):
        sel = tglr > thr
        ndetect = int(sel.sum())
        if ndetect == 0:
            res.append((thr, 0, 0, 0, nref))
            continue
        kdt = cKDTree(np.array([xM[sel], yM[sel], zM[sel]]).T)
        hits = [h for h in kdt.query_ball_tree(kdref, maxdist) if h]
        ntrue = len(hits)
        found = set()
        for h in hits:
            found.update(h)
        res.append((thr, ndetect, ntrue, ndetect - ntrue, nref - len(found)))

    tbl = Table(rows=res, names=["thresh", "ndetect", "ntrue", "nfalse", "nmiss"])
    with np.errstate(divide="ignore", invalid="ignore"):
        tbl["purity"] = 1 - np.asarray(tbl["nfalse"]) / np.asarray(tbl["ndetect"])

    if plot:
        import matplotlib.pyplot as plt

        if ax is None:
            _, ax = plt.subplots(figsize=(7, 7))
        ax.plot(tbl["thresh"], tbl["purity"], drawstyle="steps-mid",
                label="true purity")
        if pval is not None:
            sel = (np.asarray(pval["Tval_r"]) >= threshmin) & (
                np.asarray(pval["Tval_r"]) <= threshmax
            )
            ax.plot(np.asarray(pval["Tval_r"])[sel],
                    np.asarray(pval["Pval_r"])[sel],
                    drawstyle="steps-mid", label="estimated purity")
        ax.plot(tbl["thresh"], 1 - np.asarray(tbl["nmiss"]) / nref,
                drawstyle="steps-mid", label="completeness")
        ax.set_ylim((0, 1))
        ax.set_ylabel("purity / completeness")
        ax.legend()
    return tbl
