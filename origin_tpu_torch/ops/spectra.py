"""Batched device extraction of per-source spectra (step 11).

Torch port of :mod:`origin_tpu.ops.spectra`.  Every spectrum of every
source (sky, total, white-light and PSF weighted, and one weighted by each
line's narrow-band image) is reduced on the device, chunk of sources by
chunk, and only the (Nz,) vectors come to the host.  The arithmetic is
``artifacts.source.Source.extract_spectra``'s: zero-filled sums, weights
normalised by their peak, the matched-filter estimator
``sum(w d / var) / sum(w^2 / var)``.

The JAX engine pads the zero-filled cube, the inf-filled variance and the
mask by a halo and slices windows of the padded copies.  Here each window
is gathered at field coordinates with the pad values as fills (data 0,
variance inf, mask True), which gives the padded slice's values without
three cube-sized copies.  The JAX package's batch buckets
(``_bucket4``, ``_trim2``, ``ORIGIN_TPU_SPECTRA_CHUNK``) bound XLA
recompiles and are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from .lines import gather_windows

__all__ = ["source_spectra", "batched_source_spectra"]


def _windows(cube, var, mask, y0, x0, m):
    """(d, valid, inv) of the (B, Nz, m, m) windows starting at (y0, x0)."""
    cy, cx = y0 + m // 2, x0 + m // 2
    d = gather_windows(cube, cy, cx, m, 0.0)
    v = gather_windows(var, cy, cx, m, torch.inf)
    valid = ~gather_windows(mask, cy, cx, m, True)
    inv = torch.where(valid & (v > 0) & torch.isfinite(v), 1.0 / v, 0.0)
    return d, valid, inv


def _dot(a, w):
    """``einsum("zyx,yx->z")`` batched over the leading axis."""
    return torch.einsum("bzyx,byx->bz", a, w)


def _weighted(dv_s, dv_p, inv, w):
    """(spec_skysub, var, spec_plain, var) for normalised weight maps.

    ``w`` is (B, m, m).  A NaN in ``w`` makes its peak NaN, and then ``w``
    stays unnormalised, as ``jnp.where(peak > 0, ...)`` leaves it.
    """
    peak = torch.amax(w, dim=(1, 2))[:, None, None]
    w = torch.where(peak > 0, w / peak, w)
    den = _dot(inv, w * w)
    den = torch.where(den == 0, torch.inf, den)
    return _dot(dv_s, w) / den, 1.0 / den, _dot(dv_p, w) / den, 1.0 / den


def source_spectra(cube, var, mask, y0, x0, objm, skym, wcube, lsrc, lw, m,
                   has_psf):
    """All per-source and per-line spectra for one cutout size.

    Parameters
    ----------
    cube, var, mask : (Nz, Ny, Nx) tensors: zero-filled data, inf-filled
        variance, True-masked validity (the session's resident inputs)
    y0, x0 : (B,) int64 window starts IN THE FIELD (may be negative or
        reach past the edge: those cells read data 0, variance inf, mask
        True)
    objm, skym : (B, m, m) float32 object / sky masks (0/1)
    wcube : (Nz, m, m) float32 PSF weight cube (ignored if not has_psf)
    lsrc : (L,) int64 source index of each line job
    lw : (L, m, m) float32 narrow-band weight image of each line job
    m : cutout edge
    has_psf : whether to produce the PSF-weighted spectra

    Returns a dict of (B, Nz) / (L, Nz) float32 tensors, and the (B, m, m)
    white-light images under ``white_img``.
    """
    d, valid, inv = _windows(cube, var, mask, y0, x0, m)
    nsky = torch.clamp(skym.sum(dim=(1, 2)), min=1.0)
    sky = _dot(d, skym) / nsky[:, None]
    dsub = torch.where(valid, d - sky[:, :, None, None], 0.0)
    dv_s = dsub * inv
    dv_p = d * inv
    # white-light weight: masked mean over z (NaN where never valid,
    # matching the host Cube.mean)
    cnt = valid.sum(dim=1).to(torch.float32)
    white = torch.where(cnt > 0, d.sum(dim=1) / cnt, torch.nan)
    ws, wv, wps, wpv = _weighted(dv_s, dv_p, inv,
                                 torch.where(objm > 0, white, 0.0))
    out = dict(sky=sky, tot_s=_dot(dsub, objm), tot_p=_dot(d, objm),
               white_s=ws, white_s_var=wv, white_p=wps, white_p_var=wpv,
               white_img=white)
    if has_psf:
        w = wcube[None] * objm[:, None]
        den = torch.sum(w * w * inv, dim=(2, 3))
        den = torch.where(den == 0, torch.inf, den)
        out.update(psf_s=torch.sum(w * dv_s, dim=(2, 3)) / den,
                   psf_s_var=1.0 / den,
                   psf_p=torch.sum(w * dv_p, dim=(2, 3)) / den,
                   psf_p_var=1.0 / den)
    if lsrc.shape[0]:
        ls, lv, lp, lpv = _weighted(
            dv_s[lsrc], dv_p[lsrc], inv[lsrc],
            torch.where(objm[lsrc] > 0, lw, 0.0))
        out.update(line_s=ls, line_s_var=lv, line_p=lp, line_p_var=lpv)
    return out


def batched_source_spectra(cube, var, mask, jobs, wcube=None, chunk=8):
    """Run :func:`source_spectra` for a list of source jobs.

    ``jobs`` is a list of dicts with keys ``key`` (source id), ``y0``/``x0``
    (window start in FIELD coordinates), ``objm``/``skym`` ((m, m) bool),
    and ``lines``: a list of ``(num_line, (m, m) float32 weight image)``.
    All jobs share one cutout size ``m`` (callers group by size).  Jobs
    run ``chunk`` at a time, so the (chunk, Nz, m, m) windows bound the
    device memory.

    Returns ``{source_id: {tag: (Nz,) np.float32 or (spec, var)}}`` with
    tags MUSE_SKY / MUSE_TOT[_SKYSUB] / MUSE_WHITE[_SKYSUB] /
    MUSE_PSF[_SKYSUB] / ORI_CORR_<num>[_SKYSUB], and the (m, m)
    white-light image under MUSE_WHITE_IMG.
    """
    if not jobs:
        return {}
    dev = cube.device
    m = jobs[0]["objm"].shape[0]
    has_psf = wcube is not None
    wdev = (torch.as_tensor(np.asarray(wcube, np.float32), device=dev)
            if has_psf else None)
    def stack(vals, dtype):
        return torch.as_tensor(np.asarray(vals, dtype), device=dev)

    out = {}
    for i in range(0, len(jobs), chunk):
        cjobs = jobs[i:i + chunk]
        ljobs = [(k, num, w) for k, j in enumerate(cjobs)
                 for num, w in j["lines"]]
        res = source_spectra(
            cube, var, mask,
            stack([j["y0"] for j in cjobs], np.int64),
            stack([j["x0"] for j in cjobs], np.int64),
            stack([j["objm"] for j in cjobs], np.float32),
            stack([j["skym"] for j in cjobs], np.float32),
            wdev, stack([k for k, _, _ in ljobs], np.int64),
            stack(np.reshape([w for _, _, w in ljobs], (-1, m, m)),
                  np.float32),
            m, has_psf)
        host = {k: v.cpu().numpy() for k, v in res.items()}
        _decode_spectra_chunk(out, host, cjobs, ljobs, has_psf)
    return out


def _decode_spectra_chunk(out, host, jobs, ljobs, has_psf):
    for i, j in enumerate(jobs):
        d = {
            "MUSE_SKY": host["sky"][i],
            "MUSE_TOT_SKYSUB": host["tot_s"][i],
            "MUSE_TOT": host["tot_p"][i],
            "MUSE_WHITE_SKYSUB": (host["white_s"][i],
                                  host["white_s_var"][i]),
            "MUSE_WHITE": (host["white_p"][i], host["white_p_var"][i]),
        }
        if has_psf:
            d["MUSE_PSF_SKYSUB"] = (host["psf_s"][i], host["psf_s_var"][i])
            d["MUSE_PSF"] = (host["psf_p"][i], host["psf_p_var"][i])
        # not a spectrum: the (m, m) white-light image, computed as the
        # kernel's weight anyway — callers pop it for the MUSE_WHITE HDU
        d["MUSE_WHITE_IMG"] = host["white_img"][i]
        out[j["key"]] = d
    for k, (i, num, _w) in enumerate(ljobs):
        key = jobs[i]["key"]
        out[key][f"ORI_CORR_{num}_SKYSUB"] = (
            host["line_s"][k], host["line_s_var"][k]
        )
        out[key][f"ORI_CORR_{num}"] = (
            host["line_p"][k], host["line_p_var"][k]
        )
    return out
