"""Spatio-spectral friends-of-friends merging of raw detections.

Host-side reimplementation of reference lib_origin.py:1259-1387
(`itersrc` / `spatiospectral_merging`), with the recursion replaced by an
explicit DFS stack that preserves the reference's traversal order (candidate
lists in index order, immediate descent).

Semantics: starting from each unmatched seed, neighbours within ``tol_spat``
pixels join the group; neighbours that are further than ``tol_spat *
sqrt(2)`` from the *seed* only join when their wavelength is within
``tol_spec`` channels of the seed's.  A second pass merges groups that share
a continuum segmap region when their line wavelengths come within
``tol_spec``.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


__all__ = ["spatiospectral_merging", "filter_duplicate_lines"]


def _merge_groups(x, y, z, tol_spat, tol_spec):
    """First (spatial) pass. Returns imatch (group seed index per row).

    Uses the native C++ core (origin_tpu.native) when available — identical
    traversal, grid-accelerated — and falls back to the Python DFS.
    """
    from origin_tpu import native

    res = native.fof_merge_groups(x, y, z, tol_spat, tol_spec)
    if res is not None:
        return res
    return _merge_groups_py(x, y, z, tol_spat, tol_spec)


def _merge_groups_py(x, y, z, tol_spat, tol_spec):
    """Pure-Python reference implementation of the FoF grouping."""
    n = len(x)
    matched = np.zeros(n, dtype=bool)
    imatch = np.arange(n)
    sq2 = tol_spat * np.sqrt(2.0)

    for seed in range(n):
        if matched[seed]:
            continue
        matched[seed] = True
        # DFS with explicit frames: (candidate indices, cursor)
        stack = []

        def candidates_of(node):
            spatdist = np.hypot(x[node] - x, y[node] - y)
            spatdist[matched] = np.inf
            return np.where(spatdist < tol_spat)[0]

        stack.append([candidates_of(seed), 0])
        while stack:
            frame = stack[-1]
            cands, pos = frame
            if pos >= len(cands):
                stack.pop()
                continue
            frame[1] += 1
            cand = cands[pos]
            if matched[cand]:
                continue
            seed_dist = np.hypot(x[seed] - x[cand], y[seed] - y[cand])
            if seed_dist > sq2:
                if abs(z[cand] - z[seed]) >= tol_spec:
                    continue
            matched[cand] = True
            imatch[cand] = seed
            stack.append([candidates_of(cand), 0])
    return imatch


def spatiospectral_merging(tbl, tol_spat, tol_spec):
    """Merge raw detections spatially then spectrally within segmap regions.

    ``tbl`` must contain columns x0, y0, z0 and area (continuum segmap label
    at the detection position).  Returns the table sorted by the final group
    id, with columns ``imatch`` (spatial+spectral id) and ``imatch2``
    (spatial-only id) added.
    """
    x = np.asarray(tbl["x0"], dtype=float)
    y = np.asarray(tbl["y0"], dtype=float)
    z = np.asarray(tbl["z0"], dtype=float)

    imatch = _merge_groups(x, y, z, tol_spat, tol_spec)

    out = tbl.copy()
    area = np.asarray(out["area"]).copy()
    # renumber groups 0..G-1; the group's area label is the max area label of
    # its members (so a group partly inside a segmap region counts as inside)
    new_imatch = np.zeros(len(out), dtype=int)
    for n, val in enumerate(np.unique(imatch)):
        sel = imatch == val
        area[sel] = area[sel].max()
        new_imatch[sel] = n
    out["area"] = area
    out["imatch"] = new_imatch
    out.sort("imatch")

    iout = np.asarray(out["imatch"]).copy()
    out["imatch2"] = iout.copy()
    zout = np.asarray(out["z0"], dtype=float)
    areas_sorted = np.asarray(out["area"])

    # second pass: within every segmap region, merge groups whose line
    # wavelengths approach within tol_spec (reference lib_origin.py:1366-1384)
    for area_cu in np.unique(areas_sorted):
        if area_cu <= 0:
            continue
        ind = np.where(areas_sorted == area_cu)[0]
        group_dep = np.unique(iout[ind])
        for cu in group_dep:
            group = np.unique(iout[ind])
            if len(group) == 1:
                break
            if cu not in group:
                continue
            for otg in group:
                if otg == cu:
                    continue
                zin = zout[iout == cu]
                zot = zout[iout == otg]
                if np.abs(zin[:, None] - zot[None, :]).min() < tol_spec:
                    iout[iout == otg] = cu
    out["imatch"] = iout
    return out


def filter_duplicate_lines(cat_cor, cat_std, maxdist):
    """Indices of std-cube detections NOT matched by a correl detection.

    Reference steps.py:984-995: a cKDTree ball query of radius
    ``maxdist`` around every correl detection marks nearby std detections
    as duplicates.
    """
    if len(cat_std) == 0:
        return []
    if len(cat_cor) == 0:
        return list(range(len(cat_std)))
    kdt_cor = cKDTree(
        np.array([cat_cor["x0"], cat_cor["y0"], cat_cor["z0"]]).T
    )
    kdt_std = cKDTree(
        np.array([cat_std["x0"], cat_std["y0"], cat_std["z0"]]).T
    )
    matched = set()
    for hits in kdt_cor.query_ball_tree(kdt_std, maxdist):
        matched.update(hits)
    return sorted(set(range(len(cat_std))) - matched)
