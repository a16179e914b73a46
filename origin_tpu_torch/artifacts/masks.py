"""Source and sky mask generation.

(The port's copy of ``origin_tpu/artifacts/masks.py``.)

Reimplementation of reference source_masks.py and lib_origin.py:2225-2372
(`create_masks`): per source, segment the max-image of the detection cube
around each line, OR in an FWHM-scaled disc, grow the mask size (x1.5, up to
4 retries) when the source touches the cutout edge or leaves too few sky
pixels, then trim back to the smallest valid size.

The per-line max-images of a retry round come from one batched gather and
reduction on the device (:func:`origin_tpu_torch.ops.cutouts.line_max_images`
over a :class:`~origin_tpu_torch.pipeline.products.TensorCube`) covering
every still-pending source, instead of the reference's per-source subcube
downloads: only (nlines, size, size) images come to the host.  The
recursive retry of the reference becomes an explicit round loop over sizes
mask_size * 1.5**k, preserving its size progression, failure conditions and
log messages.
"""

from __future__ import annotations

import logging

import numpy as np

from .. import tracing
from ..core.containers import Image, cutout_window, cutout_wcs
from ..detect.segmentation import detect_sources
from ..ops.cutouts import line_max_images
from ..parallel.mesh import windowed
from ..pipeline.products import TensorCube
from ..utils import progressbar

__all__ = ["gen_source_mask", "create_masks"]

logger = logging.getLogger(__name__)


def _touches_edge(arr):
    return bool(
        np.any(arr[0, :]) or np.any(arr[-1, :]) or np.any(arr[:, 0])
        or np.any(arr[:, -1])
    )


def _trimmed(arr, border):
    return arr[border:-border, border:-border]


def _mask_sizes(mask_size, max_steps=5):
    """The retry size ladder: odd-adjusted mask_size, then x1.5 per step."""
    size = int(mask_size)
    for _ in range(max_steps):
        if size % 2 == 0:
            logger.debug("Mask size must be odd; using %d", size + 1)
            size += 1
        yield size
        size = int(size * 1.5)


def _line_zrange(z, fwhm_line, nz):
    """Inclusive spectral slab of a line's max-image (get_image clamping)."""
    zlo = max(0, int(z - fwhm_line))
    zhi = min(nz - 1, int(z + fwhm_line))
    return zlo, zhi


def _fetch_line_images(detection_cube, jobs, size):
    """Max-images for every (source, line) job at one cutout size.

    ``jobs`` is a list of ``(key, x, y, [(num_line, zlo, zhi), ...])`` with
    pre-clamped spectral ranges.  Returns ``{(key, num_line): (data, mask)}``
    with get_image(max) semantics: invalid pixels (outside the field, or
    non-finite max) are masked and zero-filled; ``mask`` is None when every
    pixel is valid.

    When the cube is device-resident (TensorCube), all images come from
    one batched gather and reduction on its device; otherwise the host
    path cuts one subcube per source, as the reference does.
    """
    out = {}
    if isinstance(detection_cube, TensorCube) and len(jobs):
        y0s, x0s, zlos, zhis, keys = [], [], [], [], []
        for key, x, y, lines in jobs:
            wy0, wx0 = cutout_window(y, x, size)
            for num_line, zlo, zhi in lines:
                y0s.append(wy0)
                x0s.append(wx0)
                zlos.append(zlo)
                zhis.append(zhi)
                keys.append((key, num_line))
        imgs, _ = windowed(
            lambda c, y, x, zl, zh: line_max_images(c, y, x, zl, zh,
                                                    int(size)),
            detection_cube.tensor, np.asarray(y0s), int(size),
            np.asarray(x0s), np.asarray(zlos), np.asarray(zhis))
        for key, img in zip(keys, imgs.cpu().numpy()):
            mask = ~np.isfinite(img)
            data = np.where(mask, 0.0, img)
            out[key] = (data, mask if mask.any() else None)
        return out

    for key, x, y, lines in jobs:
        sub_cube = detection_cube.subcube(center=(y, x), size=size)
        for num_line, zlo, zhi in lines:
            max_map = sub_cube.get_image(wave=(zlo, zhi), method="max")
            out[(key, num_line)] = (max_map.data, max_map.mask)
    return out


def _single_pass(
    source_id,
    lines,
    line_images,
    threshold,
    sky,
    sub_wcs,
    fwhm,
    out_dir,
    *,
    mask_size,
    seg_npixel,
    min_sky_pixels,
    fwhm_factor,
    verbose=False,
    step=1,
    key=None,
):
    """One mask-building attempt at a fixed cutout size.

    Returns (source_mask bool, sky_mask int, is_wrong).
    """
    is_wrong = False
    sky_mask = (
        np.where(sky.mask, 0, sky.data).astype(int)
        if sky.mask is not None else sky.data.astype(int)
    )
    source_mask = np.zeros((mask_size, mask_size), dtype=bool)

    pix = sub_wcs.sky2pix(
        np.stack([np.asarray(lines["dec"]), np.asarray(lines["ra"])], axis=1)
    )
    lines_y, lines_x = pix[:, 0], pix[:, 1]

    for x_line, y_line, z_line, num_line in zip(
        lines_x, lines_y, np.asarray(lines["z"], dtype=int),
        np.asarray(lines["num_line"]),
    ):
        data, msk = line_images[(key, num_line)]

        # invalid pixels of THIS line's max image (reference max_map.mask),
        # not the mask of an arbitrary spectral plane
        segmap = detect_sources(data, threshold, seg_npixel, mask=msk)

        xi, yi = int(np.round(x_line)), int(np.round(y_line))
        if not (0 <= yi < mask_size and 0 <= xi < mask_size):
            is_wrong = True
            logger.error(
                "The line %d associated to source %d is too far from the "
                "source position given the mask size (%d).",
                num_line, source_id, mask_size,
            )
            break
        seg_line = 0 if segmap is None else int(segmap[yi, xi])
        line_mask = (
            segmap == seg_line if seg_line != 0
            else np.zeros((mask_size, mask_size), dtype=bool)
        )

        radius = int(np.ceil(0.5 * fwhm_factor * fwhm[z_line]))
        yy, xx = np.mgrid[:mask_size, :mask_size]
        line_mask = line_mask | (
            ((xx - xi) ** 2 + (yy - yi) ** 2) <= radius ** 2
        )
        if verbose:
            with tracing.span("masks.write"):
                Image(data=data, mask=msk, wcs=sub_wcs).write(
                    f"{out_dir}/S{source_id}_L{num_line}_step{step}_cor.fits"
                )
        source_mask |= line_mask

    sky_mask[source_mask] = 0

    is_wrong |= (
        _touches_edge(source_mask)
        or int(np.sum(sky_mask == 1)) < min_sky_pixels
    )
    return source_mask, sky_mask, is_wrong


def _trim_masks(source_mask, sky_mask, min_size, min_sky_npixels):
    """Shrink the masks to the smallest size keeping all constraints."""
    initial = len(source_mask)
    border = 1
    while (
        initial - 2 * border >= min_size
        and not _touches_edge(_trimmed(source_mask, border))
        and int(np.sum(_trimmed(sky_mask, border) == 1)) >= min_sky_npixels
    ):
        border += 1
    border -= 1
    if border > 1:
        source_mask = _trimmed(source_mask, border)
        sky_mask = _trimmed(sky_mask, border)
    touch = _touches_edge(source_mask)
    not_enough_sky = int(np.sum(sky_mask == 1)) < min_sky_npixels
    return source_mask, sky_mask, border if border > 1 else 0, touch, not_enough_sky


def _finalize_mask(
    source_id, source_mask, sky_mask, sub_wcs, out_dir, *,
    mask_size, min_sky_npixels,
):
    """Trim, write the FITS pair, and report problems (returns source_id
    when the mask is problematic, else None)."""
    source_mask, sky_mask, border, touch, not_enough_sky = _trim_masks(
        source_mask, sky_mask, min_size=mask_size,
        min_sky_npixels=min_sky_npixels,
    )
    if touch:
        logger.error(
            "Mask creation problem: the source %s touches the edge of the "
            "mask.", source_id,
        )
    if not_enough_sky:
        logger.error(
            "Mask creation problem: the source %s has not enough sky "
            "pixels.", source_id,
        )
    if border and sub_wcs is not None:
        sub_wcs = sub_wcs[border:-border, border:-border]

    with tracing.span("masks.write"):
        Image(data=source_mask.astype(np.int64), wcs=sub_wcs).write(
            f"{out_dir}/source-mask-%0.5d.fits" % source_id
        )
        Image(data=sky_mask.astype(np.int64), wcs=sub_wcs).write(
            f"{out_dir}/sky-mask-%0.5d.fits" % source_id
        )
    if touch or not_enough_sky:
        return source_id


def gen_source_mask(
    source_id,
    x,
    y,
    lines,
    detection_cube,
    threshold,
    cont_sky,
    fwhm,
    out_dir,
    *,
    mask_size=25,
    seg_npixel=5,
    min_sky_npixels=100,
    fwhm_factor=2,
    verbose=False,
):
    """Generate and write the source mask + sky mask FITS of one source.

    Returns source_id when the mask is problematic (touches the edge or has
    too few sky pixels after all retries), else None.
    (Reference source_masks.py:281-401.)
    """
    nz = detection_cube.shape[0]
    zjobs = [
        (num_line,) + _line_zrange(z, fwhm_line, nz)
        for z, fwhm_line, num_line in zip(
            np.asarray(lines["z"], dtype=int), np.asarray(lines["fwhm"]),
            np.asarray(lines["num_line"]),
        )
    ]
    sizes = list(_mask_sizes(mask_size))
    for step, size in enumerate(sizes, start=1):
        sky = cont_sky.subimage(center=(y, x), size=size)
        wy0, wx0 = cutout_window(y, x, size)
        sub_wcs = cutout_wcs(detection_cube.wcs, wy0, wx0, size)
        line_images = _fetch_line_images(
            detection_cube, [(source_id, x, y, zjobs)], size
        )
        source_mask, sky_mask, is_wrong = _single_pass(
            source_id, lines, line_images, threshold, sky, sub_wcs, fwhm,
            out_dir, mask_size=size, seg_npixel=seg_npixel,
            min_sky_pixels=min_sky_npixels, fwhm_factor=fwhm_factor,
            verbose=verbose, step=step, key=source_id,
        )
        if not is_wrong:
            break
        if step < len(sizes):
            logger.debug(
                "Source %s mask can't be done with size %s px at step %s. "
                "Trying with %s px.", source_id, size, step, sizes[step],
            )
        else:
            logger.error(
                "Source %s mask couldn't be done after %s attempts with a "
                "mask size up to %s.", source_id, step, size,
            )
    return _finalize_mask(
        source_id, source_mask, sky_mask, sub_wcs, out_dir,
        mask_size=mask_size, min_sky_npixels=min_sky_npixels,
    )


def create_masks(
    line_table,
    source_table,
    profile_fwhm,
    cube_correl,
    threshold_correl,
    cube_std,
    threshold_std,
    segmap,
    fwhm,
    out_dir,
    *,
    mask_size=25,
    min_sky_npixels=100,
    seg_thres_factor=0.5,
    fwhm_factor=2,
    plot_problems=True,
):
    """Create the source and sky masks of every source.

    Primary (comp=0) sources segment the correlation cube; complementary
    (comp=1) sources segment the std cube, each at ``threshold *
    seg_thres_factor``.  (Reference lib_origin.py:2225-2372.)

    Sources are processed in retry rounds: all still-pending sources of a
    round share one batched device reduction per detection cube, so only
    the (nlines, size, size) max-images come to the host.
    """
    line_table = line_table.copy()
    # segmentation at the raw detection position (x0/y0/z0), not the refined
    # one, which may fall outside the segment
    sky = cube_correl.wcs.pix2sky(
        np.stack(
            [np.asarray(line_table["y0"], float),
             np.asarray(line_table["x0"], float)], axis=1,
        )
    )
    line_table["dec"] = sky[:, 0]
    line_table["ra"] = sky[:, 1]
    line_table["z"] = np.asarray(line_table["z0"])
    line_table["fwhm"] = np.asarray(
        [profile_fwhm[p] for p in np.asarray(line_table["profile"], int)]
    )

    skymap = Image(
        data=(np.asarray(segmap.data) == 0).astype(int), wcs=segmap.wcs,
        copy=False,
    )

    cubes = {0: cube_correl, 1: cube_std}
    thresholds = {
        0: threshold_correl * seg_thres_factor,
        1: threshold_std * seg_thres_factor,
    }

    src_by_id = {int(i): k for k, i in enumerate(np.asarray(source_table["ID"]))}
    grouped = line_table.group_by("ID")

    pending = []
    for group in grouped.groups:
        source_id = int(group["ID"][0])
        k = src_by_id[source_id]
        comp = int(np.asarray(source_table["comp"])[k])
        nz = cubes[comp].shape[0]
        zjobs = [
            (num_line,) + _line_zrange(z, fwhm_line, nz)
            for z, fwhm_line, num_line in zip(
                np.asarray(group["z"], dtype=int),
                np.asarray(group["fwhm"]),
                np.asarray(group["num_line"]),
            )
        ]
        pending.append(dict(
            source_id=source_id,
            x=float(np.asarray(source_table["x"])[k]),
            y=float(np.asarray(source_table["y"])[k]),
            comp=comp,
            lines=group,
            zjobs=zjobs,
        ))

    bar = progressbar(total=len(pending), desc="masks", leave=False)
    sizes = list(_mask_sizes(mask_size))
    problematic = []
    for step, size in enumerate(sizes, start=1):
        if not pending:
            break
        # one batched device fetch per detection cube for this round
        line_images = {}
        for comp, cube in cubes.items():
            jobs = [
                (r["source_id"], r["x"], r["y"], r["zjobs"])
                for r in pending if r["comp"] == comp
            ]
            if jobs:
                line_images.update(_fetch_line_images(cube, jobs, size))

        retry = []
        for r in pending:
            source_id = r["source_id"]
            logger.debug("Making mask of source %s.", source_id)
            sky_img = skymap.subimage(center=(r["y"], r["x"]), size=size)
            wy0, wx0 = cutout_window(r["y"], r["x"], size)
            sub_wcs = cutout_wcs(cubes[r["comp"]].wcs, wy0, wx0, size)
            source_mask, sky_mask, is_wrong = _single_pass(
                source_id, r["lines"], line_images, thresholds[r["comp"]],
                sky_img, sub_wcs, fwhm, out_dir, mask_size=size,
                seg_npixel=5, min_sky_pixels=min_sky_npixels,
                fwhm_factor=fwhm_factor, step=step, key=source_id,
            )
            if is_wrong and step < len(sizes):
                logger.debug(
                    "Source %s mask can't be done with size %s px at step "
                    "%s. Trying with %s px.",
                    source_id, size, step, sizes[step],
                )
                retry.append(r)
                continue
            if is_wrong:
                logger.error(
                    "Source %s mask couldn't be done after %s attempts with "
                    "a mask size up to %s.", source_id, step, size,
                )
            ret = _finalize_mask(
                source_id, source_mask, sky_mask, sub_wcs, out_dir,
                mask_size=mask_size, min_sky_npixels=min_sky_npixels,
            )
            if ret is not None:
                problematic.append(r)
            if bar is not None and hasattr(bar, "update"):
                bar.update(1)
        pending = retry
    if bar is not None and hasattr(bar, "close"):
        bar.close()

    for r in problematic:
        ret = r["source_id"]
        logger.warning(
            "The source %s mask is problematic. You may want to check "
            "source-mask-%0.5d.fits", ret, ret,
        )
        with open(f"{out_dir}/problematic_masks.txt", "a") as out:
            out.write(f"{ret}\n")
        if plot_problems:
            gen_source_mask(
                ret, r["x"], r["y"], lines=r["lines"],
                detection_cube=cubes[r["comp"]],
                threshold=thresholds[r["comp"]],
                cont_sky=skymap, fwhm=fwhm, out_dir=out_dir,
                mask_size=mask_size, min_sky_npixels=min_sky_npixels,
                fwhm_factor=fwhm_factor, verbose=True,
            )
