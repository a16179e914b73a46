"""Post-hoc catalog editing: merge / split sources, refresh masks and files.

The port's copy of :mod:`origin_tpu.artifacts.source_update`:
human-in-the-loop fixes applied after the automated pipeline (re-assigning
lines between sources, recomputing the aggregated source rows,
regenerating masks and source files for a subset of IDs).  The catalog
edits are host code.  :func:`update_masks` runs where its detection cubes
live: a session's resident ``TensorCube`` takes the batched device gather
of :func:`.masks.create_masks`, a host ``Cube`` read from a file the host
path.
"""

from __future__ import annotations

import logging
from datetime import datetime

import numpy as np

from .masks import create_masks
from .source_creation import create_source

__all__ = ("merge_sources", "split_source", "update_masks", "update_sources",
           "update_source_table")

logger = logging.getLogger(__name__)


def _nanmax(values):
    """np.nanmax semantics (all-NaN -> NaN) without the RuntimeWarning."""
    arr = np.asarray(values, dtype=float)
    finite = arr[~np.isnan(arr)]
    return float(finite.max()) if finite.size else np.nan


def merge_sources(source_id, source_idlist, source_table, source_lines):
    """Merge the sources of ``source_idlist`` into ``source_id``."""
    if source_id not in np.asarray(source_table["ID"]):
        logger.error("Source %d not found in source table", source_id)
        return False
    ksel = np.isin(np.asarray(source_lines["ID"]), source_idlist)
    if np.sum(ksel) == 0:
        logger.error("No lines found for source %s in line table",
                     source_idlist)
        return False
    source_lines["ID"][ksel] = source_id
    keep = ~np.isin(np.asarray(source_table["ID"]), source_idlist)
    kept = source_table[keep]
    source_table.columns = kept.columns
    update_source_table(source_id, source_table, source_lines)
    return True


def split_source(source_id, num_lines_to_keep, source_table, source_lines,
                 create_new=True, new_id=None):
    """Split a source: keep the given line numbers, move the rest to a new ID.

    Returns the new source ID (or None when ``create_new`` is False).
    """
    lines = source_lines[np.asarray(source_lines["ID"]) == source_id]
    if len(lines) < 2:
        logger.error(
            "Only %d lines found in source id %d, need at least 2",
            len(lines), source_id,
        )
        return
    nums = np.asarray(lines["num_line"])
    for k in num_lines_to_keep:
        if k not in nums:
            logger.error("lines id %d not found in source id %d", k, source_id)
            return

    new_lines = [k for k in nums if k not in num_lines_to_keep]
    if create_new:
        if new_id is None:
            new_id = int(np.asarray(source_lines["ID"]).max()) + 1
        elif new_id in np.asarray(source_lines["ID"]):
            logger.error("New ID %d already exist in table", new_id)
            return
        logger.debug("Create new source %d with %s lines", new_id, new_lines)
    else:
        logger.debug("Removing %s lines from the current source", new_lines)

    for num in new_lines:
        ksel = np.asarray(source_lines["num_line"]) == num
        source_lines["ID"][ksel] = new_id if create_new else -99

    update_source_table(source_id, source_table, source_lines)

    if create_new:
        group = source_lines[np.asarray(source_lines["ID"]) == new_id]
        flux = np.asarray(group["flux"], dtype=float)
        result = {"ID": new_id}
        result["ra"] = np.average(np.asarray(group["ra"]), weights=flux)
        result["dec"] = np.average(np.asarray(group["dec"]), weights=flux)
        result["x"] = np.average(np.asarray(group["x"]), weights=flux)
        result["y"] = np.average(np.asarray(group["y"]), weights=flux)
        result["n_lines"] = int(np.sum(np.asarray(group["merged_in"]) == -9999))
        result["seg_label"] = group["seg_label"][0]
        result["comp"] = group["comp"][0]
        result["line_merged_flag"] = bool(
            np.any(np.asarray(group["line_merged_flag"]))
        )
        sub = group[np.asarray(group["merged_in"]) == -9999]
        for col in ("flux", "T_GLR", "nsigTGLR", "STD", "nsigSTD", "purity"):
            result[col] = _nanmax(sub[col])
        order = np.argsort(np.asarray(sub["flux"]))
        lbdas = np.asarray(sub["lbda"])[order]
        result["waves"] = ",".join(str(int(l)) for l in lbdas[:-4:-1])
        source_table.add_row(result)
    return new_id if create_new else None


def update_masks(
    source_idlist, line_table, source_table, profile_fwhm, cube_correl,
    threshold_correl, cube_std, threshold_std, segmap, fwhm, out_dir, *,
    mask_size=25, min_sky_npixels=100, seg_thres_factor=0.5, fwhm_factor=2,
    plot_problems=True,
):
    """Recreate the masks for a list of source IDs."""
    ksel = np.isin(np.asarray(source_table["ID"]), source_idlist)
    sel_sources = source_table[ksel]
    if len(sel_sources) == 0:
        logger.error("ID %s not found in source_table", source_idlist)
        return
    ksel = np.isin(np.asarray(line_table["ID"]), source_idlist)
    sel_lines = line_table[ksel]
    if len(sel_lines) == 0:
        logger.error("ID %s not found in line_table", source_idlist)
        return
    create_masks(
        line_table=sel_lines, source_table=sel_sources,
        profile_fwhm=profile_fwhm, cube_correl=cube_correl,
        threshold_correl=threshold_correl, cube_std=cube_std,
        threshold_std=threshold_std, segmap=segmap, fwhm=fwhm,
        out_dir=out_dir, mask_size=mask_size,
        min_sky_npixels=min_sky_npixels, seg_thres_factor=seg_thres_factor,
        fwhm_factor=fwhm_factor, plot_problems=plot_problems,
    )


def update_sources(
    source_idlist, cat3_sources, cat3_lines, origin_params, cube_cor_filename,
    cube_std_filename, mask_filename_tpl, skymask_filename_tpl,
    spectra_fits_filename, segmaps, version, profile_fwhm, out_tpl, *,
    author="", nb_fwhm=2, expmap_filename=None, wfields=None,
):
    """Recreate the source files for a list of source IDs (``wfields`` as
    in :func:`~.source_creation.create_source`)."""
    source_ts = datetime.now().isoformat()
    try:
        for source_id in source_idlist:
            logger.debug("Creating source %d", source_id)
            source_lines = cat3_lines[
                np.asarray(cat3_lines["ID"]) == source_id]
            create_source(
                source_id, cat3_sources, source_lines, origin_params,
                cube_cor_filename, cube_std_filename,
                mask_filename_tpl % source_id,
                skymask_filename_tpl % source_id,
                spectra_fits_filename, segmaps, version, source_ts,
                profile_fwhm, author=author, nb_fwhm=nb_fwhm,
                expmap_filename=expmap_filename, save_to=out_tpl % source_id,
                wfields=wfields,
            )
    finally:
        # per-source lazy loads shared rebuild contexts pinning the full
        # raw views in host RAM; drop them now that the batch is done
        from ..pipeline.recipes import clear_rebuild_contexts

        clear_rebuild_contexts()


def update_source_table(source_id, source_table, source_lines):
    """Refresh the aggregated row of ``source_id`` from its lines."""
    ksel = np.asarray(source_table["ID"]) == source_id
    group = source_lines[np.asarray(source_lines["ID"]) == source_id]
    flux = np.asarray(group["flux"], dtype=float)

    source_table["ra"][ksel] = np.average(np.asarray(group["ra"]), weights=flux)
    source_table["dec"][ksel] = np.average(np.asarray(group["dec"]),
                                           weights=flux)
    source_table["x"][ksel] = np.average(np.asarray(group["x"]), weights=flux)
    source_table["y"][ksel] = np.average(np.asarray(group["y"]), weights=flux)
    source_table["n_lines"][ksel] = int(
        np.sum(np.asarray(group["merged_in"]) == -9999)
    )
    source_table["seg_label"][ksel] = group["seg_label"][0]
    source_table["comp"][ksel] = group["comp"][0]
    source_table["line_merged_flag"][ksel] = bool(
        np.any(np.asarray(group["line_merged_flag"]))
    )
    sub = group[np.asarray(group["merged_in"]) == -9999]
    for col in ("flux", "T_GLR", "nsigTGLR", "STD", "nsigSTD", "purity"):
        source_table[col][ksel] = _nanmax(sub[col])
    order = np.argsort(np.asarray(sub["flux"]))
    lbdas = np.asarray(sub["lbda"])[order]
    source_table["waves"][ksel] = ",".join(
        str(int(l)) for l in lbdas[:-4:-1]
    )
