"""Per-detection line estimation (flux, refined position, spectrum).

Torch port of :mod:`origin_tpu.ops.lines`, batched over detections: every
function takes a leading batch axis where the JAX package ``vmap``-s a
per-detection function, and the grid offsets run one after the other, as
its ``lax.map`` runs them.  The two rank-1 PCAs of a detection are the
whole-budget power iteration of :func:`.pca.rank1_left_vectors`, which the
JAX package also runs when its float32 stop test does not fire (ROADMAP.md
section 3).

The JAX package's documented deviations from the reference are kept:
- the spectral search window is clamped inside the cube (the reference's
  ``maxz = z0 - 5 + z_est`` can go negative for detections within 5 channels
  of the blue edge, lib_origin.py:1726);
- for mosaics with size_grid > 0 the combined PSF is rebuilt from the
  original per-field PSFs at every grid offset (the reference overwrites its
  psf variable on the first offset, lib_origin.py:1713-1717);
- a z_est == 0 offset only invalidates that offset instead of aborting the
  remaining column of the grid scan (lib_origin.py:1723-1724).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..device import resolve_device
from .dct import dctmat
from .pca import rank1_left_vectors
from .prec import sqrt_rn

__all__ = ["ls_deconv_wgt", "method_pca_wgt", "gather_windows",
           "grid_analysis_batch", "estimation_line_arrays"]

_KEYS = ("flux", "residual", "line", "line_var", "y", "x", "z", "ok")


def ls_deconv_wgt(data, var, psf):
    """Variance-weighted LS point-source amplitude per channel.

    Reference lib_origin.py:1482-1510, including its asymmetric weighting
    (data / sqrt(var) vs psf^2 / var).
    Shapes: (..., nl, S, S) -> (..., nl), (..., nl); ``psf`` broadcasts.
    """
    p = psf.flatten(-2)
    v = var.flatten(-2)
    d = data.flatten(-2)
    varest = 1.0 / torch.sum(p * p / v, dim=-1)
    deconv = torch.sum(p * d / sqrt_rn(v), dim=-1) * varest
    return deconv, varest


def _outer(u, x):
    """u u^T x for each of a batch: (B, nl) and (B, nl, n) -> (B, nl, n)."""
    return u[:, :, None] * torch.bmm(u[:, None, :], x)


def method_pca_wgt(data, var, psf, d0):
    """PCA-LS (or DCT-denoised PCA-LS) line estimator on (B, nl, S, S)
    minicubes.

    Reference lib_origin.py:1535-1617.  ``psf`` is (nl, S, S) or one per
    minicube, ``d0`` the (nl, order+1) DCT basis or None for plain PCA-LS.
    Returns (estimated_line (B, nl), estimated_var (B, nl)).
    """
    b, nl = data.shape[:2]
    sqv = sqrt_rn(var)
    data_std = data / sqv
    x_std = data_std.reshape(b, nl, -1)

    x0 = x_std - torch.mean(x_std, dim=2, keepdim=True)
    u = rank1_left_vectors(x0)
    resid = data_std - _outer(u, x0).reshape(data.shape)

    deconv, _ = ls_deconv_wgt(resid, var, psf)
    conv = psf * deconv[..., None, None] * (torch.abs(psf) > 0)
    data_clean = (data - conv) / sqv

    x1 = data_clean.reshape(b, nl, -1)
    x1 = x1 - torch.mean(x1, dim=2, keepdim=True)
    u2 = rank1_left_vectors(x1)
    if d0 is not None:
        # denoise the eigenvector on the DCT subspace; the reference then
        # projects with the (now non-unit) smoothed vector as-is
        u2 = (u2 @ d0) @ d0.T
    resid = data_std - _outer(u2, x_std).reshape(data.shape)
    return ls_deconv_wgt(resid, var, psf)


def _peakdet_window(deconv, z0, half=5):
    """Index of the local max of deconv closest to z0 within +/- half.

    Mirrors reference peakdet (lib_origin.py:1793-1801) on the window
    [max(0, z0-half), min(nl, z0+half+1)) of each row of the (B, nl)
    ``deconv``.  Returns (z_est, start), each (B,).
    """
    nl = deconv.shape[1]
    i = torch.arange(2 * half + 1, device=deconv.device)
    start = torch.clamp(z0 - half, min=0)
    length = (torch.clamp(z0 + half + 1, max=nl) - start)[:, None]
    idx = torch.clamp(start[:, None] + i, 0, nl - 1)
    v = torch.gather(deconv, 1, idx)
    v = torch.where(i < length, v, -torch.inf)
    is_peak = ((i >= 1) & (i <= length - 2)
               & (v > torch.roll(v, 1, dims=1))
               & (v > torch.roll(v, -1, dims=1)))
    center = length // 2
    dist = torch.where(is_peak, (i - center) ** 2,
                       torch.iinfo(torch.int32).max)
    z_est = torch.where(is_peak.any(dim=1), torch.argmin(dist, dim=1),
                        center[:, 0])
    return z_est, start


def _window_mask(maxz, nl, half):
    """(B, nl) mask of channels in [maxz-half, maxz+half] inter [0, nl)."""
    z = torch.arange(nl, device=maxz.device)
    return (z >= maxz[:, None] - half) & (z <= maxz[:, None] + half)


def _one_offset(r1, v1, psf_eff, d0, z0, horiz, horiz_psf):
    """GridAnalysis inner loop for one spatial offset of every detection:
    ``r1`` / ``v1`` are its (B, nl, S, S) data and variance windows."""
    nl, size = r1.shape[1], r1.shape[-1]
    deconv, varest = method_pca_wgt(r1, v1, psf_eff, d0)
    z_est, start = _peakdet_window(deconv, z0)
    ok = z_est != 0
    maxz = start + z_est  # reference uses z0 - 5 + z_est; clamped variant

    # flux and MSE over the +/-5 window around the refined peak
    m5 = _window_mask(maxz, nl, 5)
    fest5 = torch.sum(torch.where(m5, deconv, 0.0), dim=1)
    mh = _window_mask(maxz, nl, horiz)
    festh = torch.sum(torch.where(mh, deconv, 0.0), dim=1)

    s0 = size // 2 - horiz_psf
    core = (Ellipsis, slice(s0, s0 + 2 * horiz_psf + 1),
            slice(s0, s0 + 2 * horiz_psf + 1))
    lcr = (psf_eff * deconv[..., None, None] * (torch.abs(psf_eff) > 0))[core]
    r1r = r1[core]

    def win_mse(mask):
        mz = mask[:, :, None, None]
        num = torch.sum(torch.where(mz, (r1r - lcr) ** 2, 0.0), dim=(1, 2, 3))
        den = torch.sum(torch.where(mz, r1r ** 2, 0.0), dim=(1, 2, 3))
        return num / den

    mse5 = win_mse(m5)
    mseh = win_mse(mh)
    return dict(
        festh=torch.where(ok, festh, 0.0),
        fest5=torch.where(ok, fest5, 0.0),
        mseh=torch.where(ok, mseh, torch.inf),
        mse5=torch.where(ok, mse5, torch.inf),
        line=torch.where(ok[:, None], deconv, 0.0),
        line_var=torch.where(ok[:, None], varest, 0.0),
        z=maxz,
        ok=ok,
    )


def gather_windows(arr, ys, xs, sg, fill):
    """(B, C, sg, sg) windows of the (C, Ny, Nx) ``arr`` centred at
    (ys, xs), cells outside the field set to ``fill``.

    One index gather at clamped indices: the JAX package's
    ``_gather_minicubes`` (clipped slice, roll, fill) and, for fields
    smaller than the window, ``_gather_minicubes_padded`` (a slice of a
    padded copy) give these values.
    """
    c, ny, nx = arr.shape
    ii = torch.arange(sg, device=arr.device) - sg // 2
    yy = ys[:, None] + ii
    xx = xs[:, None] + ii
    inside = (((yy >= 0) & (yy < ny))[:, :, None]
              & ((xx >= 0) & (xx < nx))[:, None, :])
    flat = (torch.clamp(yy, 0, ny - 1)[:, :, None] * nx
            + torch.clamp(xx, 0, nx - 1)[:, None, :])
    win = arr.reshape(c, ny * nx)[:, flat.reshape(-1)]
    win = win.reshape(c, -1, sg, sg).transpose(0, 1)
    return torch.where(inside[:, None], win, fill)


def grid_analysis_batch(red_dat, red_var, z0s, y0s, x0s, psf, red_wgt, d0,
                        ny, nx, size_grid=0, criteria="flux", horiz=5,
                        horiz_psf=1):
    """GridAnalysis of a batch of detections.

    red_dat/red_var: (B, nl, S+2g, S+2g) minicubes (var=inf outside the
    field); z0s/y0s/x0s: (B,) integer tensors; psf: (nl, S, S) single
    field or (F, nl, S, S) mosaic with red_wgt its (B, F, S+2g, S+2g)
    weight windows (None for a single field).

    Returns a dict of per-detection tensors under the keys of the JAX
    package's function.
    """
    g = size_grid
    size = red_dat.shape[-1] - 2 * g
    offsets = [(dy, dx) for dy in range(2 * g + 1) for dx in range(2 * g + 1)]
    per_off = []
    for dy, dx in offsets:
        win = (Ellipsis, slice(dy, dy + size), slice(dx, dx + size))
        if red_wgt is not None:
            psf_eff = torch.einsum("bfyx,fzyx->bzyx", red_wgt[win], psf)
        else:
            psf_eff = psf
        res = _one_offset(red_dat[win], red_var[win], psf_eff, d0, z0s,
                          horiz, horiz_psf)
        # offsets that leave the cube are invalid (reference dxl/dyl)
        inb = ((x0s + dx - g >= 0) & (x0s + dx - g < nx)
               & (y0s + dy - g >= 0) & (y0s + dy - g < ny))
        for key in ("festh", "fest5"):
            res[key] = torch.where(inb, res[key], 0.0)
        for key in ("mseh", "mse5"):
            res[key] = torch.where(inb, res[key], torch.inf)
        res["ok"] = res["ok"] & inb
        per_off.append(res)
    stack = {k: torch.stack([r[k] for r in per_off]) for k in per_off[0]}
    if criteria == "flux":
        sel = torch.argmax(stack["festh"], dim=0)
    else:
        sel = torch.argmin(stack["mseh"], dim=0)
    cols = torch.arange(sel.shape[0], device=sel.device)
    pick = {k: v[sel, cols] for k, v in stack.items()}
    off = torch.as_tensor(offsets, device=sel.device)[sel]
    return dict(flux=pick["fest5"], residual=pick["mse5"], line=pick["line"],
                line_var=pick["line_var"], y=y0s - g + off[:, 0],
                x=x0s - g + off[:, 1], z=pick["z"], ok=pick["ok"])


def estimation_line_arrays(x0, y0, z0, raw, var, psf, weights=None,
                           size_grid=0, criteria="flux", order_dct=30,
                           horiz_psf=1, horiz=5, batch=64, engine=None,
                           device="cuda"):
    """Estimate lines for detections at (x0, y0, z0) pixel positions.

    Mirrors reference estimation_line (lib_origin.py:1804-1938) minus the
    catalog bookkeeping: gathers each chunk of ``batch`` detections'
    minicubes, runs :func:`grid_analysis_batch` on them and returns numpy
    arrays (flux, residual, lines (N, Nz), line_vars (N, Nz), y, x, z, ok).

    With ``engine`` (a :class:`~origin_tpu_torch.pipeline.engine.TorchEngine`)
    the windows are gathered on its device from the session's resident
    inputs and ``raw`` / ``var`` are not read; without one, ``raw`` and
    ``var`` are the zero-filled cube and inf-filled variance (the session's
    ``cube_raw`` and ``var``) and the work runs on ``device``.  The engine
    chooses where the windows are cut (:meth:`TorchEngine.cutting_windows`:
    on the host once a tight-memory session has dropped its inputs).
    """
    dev = engine.device if engine is not None else resolve_device(device)
    if engine is None:
        raw = torch.as_tensor(np.asarray(raw, np.float32), device=dev)
        var = torch.as_tensor(np.asarray(var, np.float32), device=dev)
        nl, ny, nx = raw.shape
    else:
        nl, ny, nx = engine.orig.shape
    if weights is None:
        psf_arr = np.asarray(psf, dtype=np.float32)
        wmaps = None
    else:
        psf_arr = np.stack([np.asarray(p, dtype=np.float32) for p in psf])
        wmaps = torch.as_tensor(
            np.stack([np.asarray(w, dtype=np.float32) for w in weights]),
            device=dev)
    g = int(size_grid)
    sg = psf_arr.shape[-1] + 2 * g
    d0 = (None if order_dct is None
          else torch.as_tensor(dctmat(nl, order_dct), device=dev))
    psf_t = torch.as_tensor(psf_arr, device=dev)

    def idx(a, ii):
        return torch.as_tensor(np.asarray(a[ii], dtype=np.int64), device=dev)

    n = len(x0)
    results = {k: [] for k in _KEYS}
    with (engine.cutting_windows(n, sg) if engine is not None
          else contextlib.nullcontext()):
        for i0 in range(0, n, batch):
            ii = slice(i0, min(n, i0 + batch))
            xs, ys, zs = idx(x0, ii), idx(y0, ii), idx(z0, ii)
            if engine is not None:
                wins = engine.minicubes(xs, ys, sg, wmaps)
            else:
                wins = (gather_windows(raw, ys, xs, sg, 0.0),
                        gather_windows(var, ys, xs, sg, torch.inf))
                if wmaps is not None:
                    wins += (gather_windows(wmaps, ys, xs, sg, 0.0),)
            out = grid_analysis_batch(
                wins[0], wins[1], zs, ys, xs, psf_t,
                wins[2] if wmaps is not None else None, d0, ny, nx,
                size_grid=g, criteria=criteria, horiz=horiz,
                horiz_psf=horiz_psf)
            del wins
            for k in _KEYS:
                v = out[k]
                if k in ("y", "x", "z"):
                    v = v.to(torch.int32)  # the JAX package's index dtype
                results[k].append(v.cpu().numpy())
    return {k: np.concatenate(v) if n else np.empty(0)
            for k, v in results.items()}
