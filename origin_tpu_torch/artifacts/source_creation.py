"""Per-source FITS file creation.

(The port's copy of ``origin_tpu/artifacts/source_creation.py``.  Every
detection-cube cutout is cut before its source's file is built, so each
file is written in one pass: the JAX package's two-phase write, which
appends that cutout once a TPU link transfer lands, is not ported.
Sources run in a thread pool when ``n_jobs != 1``, not in joblib's process
pool.)

Host-side reimplementation of reference source_creation.py: one Source file
per detected source carrying the ORIGIN parameters, data/correlation
cutouts, masks, segmaps, extracted spectra, per-line narrow-band images and
the line table.
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime

import numpy as np

from .. import tracing
from ..core.containers import Cube, Image, Spectrum
from ..core.fsf import field_weights
from ..core.table import Table
from ..utils import progressbar
from ..version import version as origin_version
from .source import Source

__all__ = ["create_source", "create_all_sources"]

logger = logging.getLogger(__name__)


def _spectra_dict(spectra_fits_filename):
    """The per-line spectra: the session's dict as given, the spectra.fits
    file read, or {} when the file does not exist."""
    if isinstance(spectra_fits_filename, dict):
        return spectra_fits_filename
    if os.path.exists(spectra_fits_filename):
        from ..pipeline.spectra_io import load_spectra

        return load_spectra(spectra_fits_filename)
    return {}


def create_source(
    source_id,
    source_table,
    source_lines,
    origin_params,
    cube_cor_filename,
    cube_std_filename,
    mask_filename,
    skymask_filename,
    spectra_fits_filename,
    segmaps,
    version,
    source_ts,
    profile_fwhm,
    *,
    author="",
    nb_fwhm=2,
    expmap_filename=None,
    save_to=None,
    data_cube=None,
    cube_ori=None,
    spectra_pre=None,
    line_images_pre=None,
    wfields=None,
):
    """Create one Source file (reference source_creation.py:26-436).

    ``data_cube`` / ``cube_ori`` may be pre-cut cutout cubes provided by
    :func:`create_all_sources`; otherwise the full cubes are read from the
    given filenames (the reference re-reads them for every source, which
    costs ~3 full-cube FITS reads per source on large fields).
    ``wfields``: the session's per-field weight maps, needed when the cube
    header holds several FSF fields; the source's FSF is then the fields'
    models averaged with their weights at the source's (x, y).
    """
    ids = np.asarray(source_table["ID"])
    k = int(np.where(ids == source_id)[0][0])
    info = source_table[k]

    mask = Image(mask_filename)
    mask_size = mask.shape[0]

    if data_cube is None:
        data_cube = Cube(origin_params["cubename"])

    # a session made from an in-memory Cube has no file name: CUBE = ""
    origin = (
        "ORIGIN",
        origin_version,
        os.path.basename(origin_params["cubename"] or ""),
        data_cube.primary_header.get("CUBE_V", ""),
    )
    source = Source.from_data(info["ID"], info["ra"], info["dec"], origin)

    h = source.header
    h["SRC_V"] = version, "Source version"
    h["SRC_TS"] = source_ts, "Timestamp of the source creation"
    h["CAT3_TS"] = (
        source_table.meta.get("CAT3_TS", ""),
        "Timestamp of the catalog creation",
    )
    source.add_history("Source created with ORIGIN", author)

    h["OR_X"] = float(info["x"]), "x position in pixels"
    h["OR_Y"] = float(info["y"]), "y position in pixels"
    h["OR_SEG"] = int(info["seg_label"]), "Label in the segmentation map"
    h["OR_V"] = origin_version, "ORIGIN version"
    h["OR_FLUX"] = float(info["flux"]), "flux maximum in all lines"
    h["OR_PMAX"] = float(info["purity"]), "maximum purity in all lines"

    if not np.isnan(info["STD"]):
        h["OR_STD"] = float(info["STD"]), "STD max value in all lines"
    if not np.isnan(info["nsigSTD"]):
        h["OR_NSTD"] = float(info["nsigSTD"]), "max of STD/std(STD) in all lines"
    if not np.isnan(info["T_GLR"]):
        h["OR_TGLR"] = float(info["T_GLR"]), "T_GLR max value in all lines"
    if not np.isnan(info["nsigTGLR"]):
        h["OR_NTGLR"] = (
            float(info["nsigTGLR"]),
            "max of T_GLR/std(T_GLR) in all lines",
        )

    # echo the run parameters into the header (reference
    # source_creation.py:157-199)
    parameters_to_add = {
        "OR_PROF": ("profiles", "OR input, spectral profiles"),
        "OR_FSF": ("PSF", "OR input, FSF cube"),
        "OR_THL%02d": ("threshold_list", "OR input threshold per area"),
        "OR_NA": ("nbareas", "OR number of areas"),
        "preprocessing": {"OR_DCT": ("dct_order", "OR input, DCT order")},
        "areas": {
            "OR_PFAA": ("pfa", "OR input, PFA used to create the area map"),
            "OR_SIZA": ("maxsize", "OR input, maximum area size in pixels"),
            "OR_MSIZA": ("minsize", "OR input, minimum area size in pixels"),
        },
        "compute_PCA_threshold": {"OR_PFAT": ("pfa_test", "OR input, PFA test")},
        "compute_greedy_PCA": {
            "OR_FBG": ("Noise_population",
                       "OR input: fraction of spectra estimated"),
            "OR_ITMAX": ("itermax", "OR input, maximum number of iterations"),
        },
        "compute_TGLR": {"OR_NG": ("size", "OR input, connectivity size")},
        "detection": {
            "OR_DXY": ("tol_spat", "OR input, spatial tolerance for merging (pix)"),
            "OR_DZ": ("tol_spec", "OR input, spectral tolerance for merging (pix)"),
        },
        "compute_spectra": {"OR_NXZ": ("grid_dxy", "OR input, grid Nxy")},
    }

    def add_keyword(keyword, param, description, params):
        if param == "threshold_list" and param in params:
            for idx, threshold in enumerate(params["threshold_list"]):
                h[keyword % idx] = float("%0.2f" % threshold), description
        elif param in params:
            value = params[param]
            h[keyword] = ("" if value is None else value), description
        else:
            logger.debug("Parameter %s absent of the parameter list.", param)

    for keyword, val in parameters_to_add.items():
        if isinstance(val, dict):
            if keyword in origin_params:
                for key, val2 in val.items():
                    add_keyword(key, *val2, origin_params[keyword]["params"])
        else:
            add_keyword(keyword, *val, origin_params)

    h["COMP_CAT"] = (
        int(info["comp"]),
        "1/0 (1=Pre-detected in STD, 0=detected in CORREL)",
    )
    comp = bool(h["COMP_CAT"])
    thr_key, pur_key = (
        ("threshold_std", "purity_std") if comp else ("threshold", "purity")
    )
    h["OR_TH"] = float("%0.2f" % origin_params[thr_key]), "OR input, threshold"
    h["OR_PURI"] = float("%0.2f" % origin_params[pur_key]), "OR input, purity"

    # device-precomputed per-source arrays (see
    # pipeline.steps.SaveSources._device_source_artifacts): the *_IMG
    # entries are images riding the spectra dict, split off here
    spectra_pre = dict(spectra_pre) if spectra_pre else None
    white_pre = maxmap_pre = corr_spec_pre = None
    if spectra_pre is not None:
        white_pre = spectra_pre.pop("MUSE_WHITE_IMG", None)
        maxmap_pre = spectra_pre.pop("ORI_MAXMAP_IMG", None)
        corr_spec_pre = spectra_pre.pop("ORI_CORR", None)

    # mini-cubes; cutouts pre-cut at mask_size by create_all_sources are
    # attached as-is (re-cutting a centred cutout to its own size is the
    # identity, and the copy costs ~20 MB per source)
    if data_cube.shape[1:] == (mask_size, mask_size):
        source.cubes["MUSE_CUBE"] = data_cube
        if white_pre is not None:
            wm = ~np.isfinite(white_pre)
            source.images["MUSE_WHITE"] = Image(
                data=white_pre, mask=wm if wm.any() else None,
                wcs=data_cube.wcs, copy=False,
            )
        else:
            source.images["MUSE_WHITE"] = data_cube.mean(axis=0)
    else:
        source.add_cube(data_cube, "MUSE_CUBE", size=mask_size,
                        add_white=True)
    has_fsf = "FSFMODE" in data_cube.primary_header
    if has_fsf:
        source.add_FSF(data_cube, weights=None if wfields is None else
                       field_weights(wfields, info["y"], info["x"]))
    else:
        logger.debug("No FSF information found in the cube")
    data_cube = source.cubes["MUSE_CUBE"]

    ori_tag = "ORI_SNCUBE" if comp else "ORI_CORREL"
    if cube_ori is None:
        from ..pipeline.recipes import load_cube

        # lazy: a recipe-stored cube_std rebuilds only this source's
        # window instead of the full field
        cube_ori = load_cube(cube_std_filename if comp else cube_cor_filename,
                             lazy=True)
    if cube_ori.shape[1:] == (mask_size, mask_size):
        source.cubes[ori_tag] = cube_ori
    else:
        source.add_cube(cube_ori, ori_tag, size=mask_size)
    cube_ori = source.cubes[ori_tag]

    # nearby sources table
    radius = mask_size / 2
    xs, ys = np.asarray(source_table["x"]), np.asarray(source_table["y"])
    nearby = (
        (xs >= info["x"] - radius)
        & (xs <= info["x"] + radius)
        & (ys >= info["y"] - radius)
        & (ys <= info["y"] + radius)
    )
    source.tables["ORI_CAT"] = source_table["ID", "ra", "dec"][nearby]

    # maps (segmaps/expmap may be pre-loaded Image objects, shared across
    # sources by create_all_sources)
    if maxmap_pre is not None:
        mm = ~np.isfinite(maxmap_pre)
        source.images["ORI_MAXMAP"] = Image(
            data=np.where(mm, np.nan, maxmap_pre),
            mask=mm if mm.any() else None, wcs=cube_ori.wcs, copy=False,
        )
    else:
        source.images["ORI_MAXMAP"] = cube_ori.max(axis=0)
    source.add_image(mask, "ORI_MASK_OBJ")
    source.add_image(Image(skymask_filename), "ORI_MASK_SKY")
    for segmap_type, segmap in segmaps.items():
        if isinstance(segmap, str):
            segmap = Image(segmap)
        source.add_image(segmap, "ORI_SEGMAP_%s" % segmap_type)
    if expmap_filename is not None:
        expmap = (
            Image(expmap_filename) if isinstance(expmap_filename, str)
            else expmap_filename
        )
        source.add_image(expmap, "EXPMAP")

    objmask = np.asarray(source.images["ORI_MASK_OBJ"].data) > 0
    if corr_spec_pre is not None:
        corr_spec = np.where(
            np.isfinite(corr_spec_pre), corr_spec_pre, 0.0
        )
    else:
        ori_masked = np.where(
            objmask[None], cube_ori.filled(np.nan), np.nan
        )
        with np.errstate(invalid="ignore"):
            corr_spec = np.nanmean(ori_masked, axis=(1, 2))
        corr_spec = np.where(np.isfinite(corr_spec), corr_spec, 0.0)
    source.spectra["ORI_CORR"] = Spectrum(
        data=corr_spec, wave=cube_ori.wave, copy=False
    )

    fwhm_fsf = beta_fsf = None
    if has_fsf:
        fsfmodel = source.get_FSF()
        lbda = data_cube.wave.coord()
        fwhm_fsf = fsfmodel.get_fwhm(lbda)
        beta_fsf = fsfmodel.get_beta(lbda)

    # per line content
    line_columns = [
        "NUM_LINE", "RA_LINE", "DEC_LINE", "LBDA_OBS", "FWHM", "FLUX",
        "GLR", "nGLR", "PROF", "PURITY",
    ]
    if comp:
        line_columns[6] = "STD"
        line_columns[7] = "nSTD"

    source.add_table(source_lines, "ORI_LINES")

    spectra_hdus = _spectra_dict(spectra_fits_filename)

    nb_par_rows = []
    corr_tags = []
    unmerged = source_lines[np.asarray(source_lines["merged_in"]) == -9999]
    for row in unmerged:
        num_line = int(row["num_line"])
        lbda_ori = float(row["lbda"])
        prof = int(row["profile"])
        fwhm_ori = profile_fwhm[prof] * data_cube.wave.get_step()
        if comp:
            glr_std, nglr_std = row["STD"], row["nsigSTD"]
        else:
            glr_std, nglr_std = row["T_GLR"], row["nsigTGLR"]

        source.add_line(
            cols=line_columns,
            values=[
                num_line, row["ra"], row["dec"], lbda_ori, fwhm_ori,
                row["flux"], glr_std, nglr_std, prof, row["purity"],
            ],
        )

        if num_line in spectra_hdus:
            source.spectra[f"ORI_SPEC_{num_line}"] = spectra_hdus[num_line]

        with tracing.span("sources.images"):
            source.add_narrow_band_image_lbdaobs(
                data_cube, f"NB_LINE_{num_line}", lbda=lbda_ori,
                width=nb_fwhm * fwhm_ori, method="sum", subtract_off=True,
                margin=10.0, fband=3.0,
            )
        nb_par_rows.append(
            [f"NB_LINE_{num_line}", lbda_ori, nb_fwhm * fwhm_ori, 10.0, 3.0]
        )
        pre_img = (line_images_pre or {}).get(num_line)
        if pre_img is not None:
            # device-computed narrow-band max image (same values as the
            # host nanmax over the cutout slab)
            source.images[f"ORI_CORR_{num_line}"] = Image(
                data=pre_img, wcs=cube_ori.wcs, copy=False
            )
        else:
            with tracing.span("sources.images"):
                source.add_narrow_band_image_lbdaobs(
                    cube_ori, f"ORI_CORR_{num_line}", lbda=lbda_ori,
                    width=nb_fwhm * fwhm_ori, method="max",
                    subtract_off=False,
                )
        corr_tags.append(f"ORI_CORR_{num_line}")

    if spectra_pre is not None:
        # spectra were reduced on device in batches
        # (pipeline.engine.TorchEngine.source_spectra); attach them
        wave = data_cube.wave
        for tag, val in spectra_pre.items():
            if isinstance(val, tuple):
                sp = Spectrum(data=val[0], var=val[1], wave=wave,
                              copy=False)
            else:
                sp = Spectrum(data=val, wave=wave, copy=False)
            source.spectra[tag] = sp
    else:
        # all spectra in TWO passes: one extract_spectra call per skysub
        # value covers the total / white / PSF-weighted spectra AND every
        # line's correlation-weighted spectrum — the per-call sky
        # spectrum, sky subtraction and 1/var products are shared instead
        # of being recomputed 4 + 2*nlines times per source
        source.extract_spectra(data_cube, skysub=True, psf=fwhm_fsf,
                               beta=beta_fsf, tags_to_try=corr_tags)
        source.extract_spectra(data_cube, skysub=False, psf=fwhm_fsf,
                               beta=beta_fsf, tags_to_try=corr_tags)

    # reference spectrum: correlation-weighted spectrum of the brightest line
    fluxes = np.asarray(source.lines["FLUX"])
    num_max = int(np.asarray(source.lines["NUM_LINE"])[np.argmax(fluxes)])
    h["REFSPEC"] = f"ORI_CORR_{num_max}_SKYSUB"

    nb_par = Table(
        rows=nb_par_rows, names=["LINE", "LBDA", "WIDTH", "MARGIN", "FBAND"]
    )
    source.add_table(nb_par, "NB_PAR")


    if save_to is not None:
        with tracing.span("sources.write"):
            source.write(save_to)
    else:
        return source


def create_all_sources(
    cat3_sources,
    cat3_lines,
    origin_params,
    cube_cor_filename,
    cube_std_filename,
    mask_filename_tpl,
    skymask_filename_tpl,
    spectra_fits_filename,
    segmaps,
    version,
    profile_fwhm,
    out_tpl,
    *,
    n_jobs=1,
    author="",
    nb_fwhm=2,
    expmap_filename=None,
    data_cube=None,
    cube_cor=None,
    cube_std=None,
    spectra_pre=None,
    line_images_pre=None,
    wfields=None,
):
    """Create and save one Source file per source.

    The data / correlation / std cubes are read ONCE and cut into
    per-source cutouts here, instead of re-reading three full cubes inside
    every job (the reference's layout, source_creation.py:439-534, costs
    O(n_sources) full-cube FITS reads on large fields).  ``data_cube`` /
    ``cube_cor`` / ``cube_std`` may be passed as in-memory cubes (the
    pipeline's live products: a device-resident ``TensorCube`` brings only
    each source's window to the host), skipping the FITS reads; the
    filenames are still recorded in the sources.  With ``n_jobs != 1`` the
    sources are built in a thread pool of that many workers (all CPUs for
    ``n_jobs <= 0``); each job carries its own cutouts, so the files do
    not depend on ``n_jobs``.  ``wfields`` as in :func:`create_source`.
    """
    source_ts = datetime.now().isoformat()
    ids = [int(s) for s in np.asarray(cat3_sources["ID"])]
    if not ids:
        return

    if data_cube is None:
        data_cube = Cube(origin_params["cubename"])
    segmaps = {k: Image(v) if isinstance(v, str) else v
               for k, v in segmaps.items()}
    if isinstance(expmap_filename, str):
        expmap_filename = Image(expmap_filename)
    spectra = _spectra_dict(spectra_fits_filename)
    comps = {}
    for source_id in ids:
        k = int(np.where(np.asarray(cat3_sources["ID"]) == source_id)[0][0])
        comps[source_id] = int(cat3_sources[k]["comp"])
    # recipe-aware: a session stores cube_std as its generator file
    # (pipeline.recipes) by default; lazy, so the comp=1 cutouts below
    # rebuild O(window), not the full field
    from ..pipeline.recipes import load_cube

    if cube_cor is None and 0 in comps.values():
        cube_cor = load_cube(cube_cor_filename)
    if cube_std is None and 1 in comps.values():
        cube_std = load_cube(cube_std_filename, lazy=True)

    def _precut(cube, source_id, size, kind):
        k = int(np.where(np.asarray(cat3_sources["ID"]) == source_id)[0][0])
        info = cat3_sources[k]
        with tracing.span("sources.cutouts", cube=kind):
            sub = cube.subcube(
                center=(float(info["dec"]), float(info["ra"])), size=size,
                unit_center="deg",
            )
        header = getattr(cube, "primary_header", None)
        if header is not None:
            sub.primary_header = header.copy()
        return sub

    def _job(source_id):
        source_lines = cat3_lines[np.asarray(cat3_lines["ID"]) == source_id]
        mask_size = Image(mask_filename_tpl % source_id).shape[0]
        ori = cube_std if comps[source_id] else cube_cor
        line_imgs = None
        if line_images_pre is not None:
            line_imgs = {
                num: img for (sid, num), img in line_images_pre.items()
                if sid == source_id
            } or None
        return dict(
            source_id=source_id,
            source_table=cat3_sources,
            source_lines=source_lines,
            origin_params=origin_params,
            cube_cor_filename=cube_cor_filename,
            cube_std_filename=cube_std_filename,
            mask_filename=mask_filename_tpl % source_id,
            skymask_filename=skymask_filename_tpl % source_id,
            spectra_fits_filename=spectra,
            segmaps=segmaps,
            version=version,
            source_ts=source_ts,
            profile_fwhm=profile_fwhm,
            author=author,
            nb_fwhm=nb_fwhm,
            expmap_filename=expmap_filename,
            save_to=out_tpl % source_id,
            data_cube=_precut(data_cube, source_id, mask_size, "raw"),
            cube_ori=_precut(ori, source_id, mask_size, "detection"),
            spectra_pre=(spectra_pre or {}).get(source_id),
            line_images_pre=line_imgs,
            wfields=wfields,
        )

    ids = progressbar(ids, desc="sources", leave=False)
    if n_jobs == 1:
        for source_id in ids:
            job = _job(source_id)
            with tracing.span("sources.build"):
                create_source(**job)
        return
    # the cutouts are cut here, one source after the other (device
    # gathers stay on this thread); the workers build and write the files
    with ThreadPoolExecutor(max_workers=n_jobs if n_jobs > 0 else None) \
            as pool:
        futures = [pool.submit(create_source, **_job(source_id))
                   for source_id in ids]
        for fut in futures:
            fut.result()
