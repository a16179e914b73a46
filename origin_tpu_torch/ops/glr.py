"""GLR matched-filter test: host profile packing, the spatial FSF stage and
the plain spectral sweep (torch port of :mod:`origin_tpu.ops.glr`).

1. Spatial stage: every channel is correlated with its zero-mean FSF (and
   the weight map with FSF^2 for the norm).  The FSF spectra and the norm
   cube are data-independent (:func:`precompute_spatial`, ``torch.fft``);
   the per-cube convolution is DFT-by-matmul (:func:`glr_spatial_matmul`),
   plain products as in the JAX package.
2. Spectral stage: each trimmed, normalized profile is a 'same'
   correlation along z, with a running max / argmax / min over the
   dictionary.  :func:`toeplitz_sweep` here is the plain version (unfold +
   matmul against the banded-Toeplitz banks); the CUDA kernel that runs
   on the GPU is :func:`origin_tpu_torch.ops.sweep.spectral_sweep`.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "prepare_profiles",
    "pack_profiles_toeplitz",
    "dft_spatial_factors",
    "precompute_spatial",
    "glr_spatial_matmul",
    "toeplitz_sweep",
]


def prepare_profiles(profiles, pcut=1e-8, pmeansub=True):
    """Trim, normalize and mean-subtract the profile dictionary (host).

    Each profile is cut to the symmetric support where it exceeds ``pcut``
    around its peak, then L2-normalized, then (optionally) mean-subtracted.
    Returns a list of (trimmed_profile, center_index) pairs where
    center = (len-1)//2 is the offset of the 'same' correlation.
    """
    out = []
    for i, prof in enumerate(profiles):
        prof = np.asarray(prof, dtype=np.float64).copy()
        if not np.any(prof > 0):
            raise ValueError(
                f"profile {i} of the dictionary has no positive samples"
            )
        if pcut is not None:
            lpeak = int(prof.argmax())
            above = np.where(prof >= pcut)[0]
            if above.size == 0:
                raise ValueError(
                    f"profile {i} of the dictionary is entirely below "
                    f"pcut={pcut}"
                )
            lw = int(np.max(np.abs(above[[0, -1]] - lpeak)))
            lo = max(0, lpeak - lw)
            prof = prof[lo : lpeak + lw + 1]
        prof = prof / np.linalg.norm(prof)
        if pmeansub:
            prof = prof - prof.mean()
        out.append((prof, (len(prof) - 1) // 2))
    return out


def pack_profiles_toeplitz(prepped, block=128):
    """Band-Toeplitz operator banks for the spectral sweep (host).

    The centred 'same' correlation with profile k is
    ``cp[z] = sum_j p_k[j] * x[z + j - c_k]``; over a z-block of ``block``
    outputs it is one (W, block) banded-Toeplitz matmul against a window of
    the input left-padded by ``pad_left = max c_k``.

    Returns (t_num, t_den, pad_left, window): (K, W, block) float32 banks
    for the profile / profile^2 filters.
    """
    k = len(prepped)
    pad_left = max(c for _, c in prepped)
    reach = max(pad_left - c + len(p) for p, c in prepped)
    window = block + reach - 1
    t_num = np.zeros((k, window, block), dtype=np.float32)
    t_den = np.zeros((k, window, block), dtype=np.float32)
    for j, (prof, c) in enumerate(prepped):
        s = pad_left - c
        length = len(prof)
        for i in range(block):
            t_num[j, s + i : s + i + length, i] = prof
            t_den[j, s + i : s + i + length, i] = np.asarray(prof) ** 2
    return t_num, t_den, pad_left, window


def dft_spatial_factors(ny, nx, fshape2, psf_shape, ny_out=None, y_extra=0):
    """Real/imag DFT factor matrices for the matmul spatial stage (host).

    The padded 2-D real FFT, the centred 'same' slice of the inverse and the
    real-symmetry weights folded into four small matrices.  Returns a dict
    of float32 arrays.
    """
    fy, fx = int(fshape2[0]), int(fshape2[1])
    fxr = fx // 2 + 1
    ph, pw = psf_shape
    y0, x0 = (ph - 1) // 2 + int(y_extra), (pw - 1) // 2
    if ny_out is None:
        ny_out = ny
    kx = np.arange(fxr)
    ax = np.exp(-2j * np.pi * np.outer(np.arange(nx), kx) / fx)  # (nx, FXr)
    ay = np.exp(
        -2j * np.pi * np.outer(np.arange(fy), np.arange(ny)) / fy
    )  # (FY, ny)
    by = (
        np.exp(
            2j * np.pi * np.outer(np.arange(ny_out) + y0, np.arange(fy)) / fy
        )
        / fy
    )  # (ny_out, FY)
    w = np.full(fxr, 2.0)
    w[0] = 1.0
    if fx % 2 == 0:
        w[-1] = 1.0
    cx = (
        w[:, None]
        * np.exp(2j * np.pi * np.outer(kx, np.arange(nx) + x0) / fx)
        / fx
    )  # (FXr, nx)
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)
    return dict(
        axr=f32(ax.real), axi=f32(ax.imag),
        ayr=f32(ay.real), ayi=f32(ay.imag),
        byr=f32(by.real), byi=f32(by.imag),
        cxr=f32(cx.real), cxi=f32(cx.imag),
    )


def precompute_spatial(psfs, wmaps, ny, nx, fshape2):
    """Data-independent part of the spatial stage, computed once per dataset.

    ``psfs`` is (F, Nz, P, P), ``wmaps`` (F, Ny, Nx) or None.  Returns
    (kern_hats, norm_fsf): the (F, Nz, fy, fx//2+1) complex bank of flipped
    zero-mean FSF spectra and the summed (Nz, Ny, Nx) norm cube.
    """
    nfields = psfs.shape[0]
    kern_hats = []
    norm_fsf = None
    for nf in range(nfields):
        kern = torch.flip(psfs[nf], dims=(1, 2))
        kern = kern - torch.mean(kern, dim=(1, 2), keepdim=True)
        kern_hats.append(torch.fft.rfft2(kern, s=fshape2))
        base = (
            torch.ones((1, ny, nx), dtype=psfs.dtype, device=psfs.device)
            if wmaps is None else wmaps[nf][None]
        )
        bf = torch.fft.rfft2(base, s=fshape2)
        k2f = torch.fft.rfft2(kern * kern, s=fshape2)
        full = torch.fft.irfft2(bf * k2f, s=fshape2)
        ph, pw = kern.shape[-2:]
        y0, x0 = (ph - 1) // 2, (pw - 1) // 2
        n = full[:, y0 : y0 + ny, x0 : x0 + nx]
        norm_fsf = n if norm_fsf is None else norm_fsf + n
    return torch.stack(kern_hats), norm_fsf.contiguous()


def glr_spatial_matmul(cube, kern_r, kern_i, wmaps, factors):
    """Spatial FSF stage as batched float32 matmuls (DFT-by-matmul).

    ``kern_r/kern_i``: (F, Nz, FY, FXr) real/imag parts of the FSF spectra
    from :func:`precompute_spatial`; ``factors`` from
    :func:`dft_spatial_factors`, as tensors.  Returns cube_fsf (Nz, Ny, Nx).
    """
    axr, axi = factors["axr"], factors["axi"]
    ayr, ayi = factors["ayr"], factors["ayi"]
    byr, byi = factors["byr"], factors["byi"]
    cxr, cxi = factors["cxr"], factors["cxi"]
    cube_fsf = None
    for nf in range(kern_r.shape[0]):
        data = cube if wmaps is None else cube * wmaps[nf][None]
        zr = data @ axr  # (z, ny, FXr)
        zi = data @ axi
        yr = ayr @ zr - ayi @ zi  # (z, FY, FXr)
        yi = ayr @ zi + ayi @ zr
        del zr, zi
        pr = yr * kern_r[nf] - yi * kern_i[nf]
        pi = yr * kern_i[nf] + yi * kern_r[nf]
        del yr, yi
        gr = byr @ pr - byi @ pi  # (z, ny, FXr)
        gi = byr @ pi + byi @ pr
        del pr, pi
        out = gr @ cxr - gi @ cxi
        cube_fsf = out if cube_fsf is None else cube_fsf + out
    return cube_fsf


def toeplitz_sweep(cube_fsf, norm_fsf, t_num, t_den, pad_left, nz,
                   max_transient_bytes=2 << 30):
    """Plain spectral sweep: unfold + matmul against the Toeplitz banks.

    Inputs are (Nz, Ny, Nx) float32 cubes and the (K, W, block) banks of
    :func:`pack_profiles_toeplitz`; returns (correl, profile_idx,
    correl_min), each (Nz, Ny, Nx).  Profile indices are uint8 for up to
    255 profiles and int32 beyond that; on a tie the first profile wins.

    The sliding-window view costs ~W/B copies of the cube, so the spaxels
    run in slabs that keep the transient memory near
    ``max_transient_bytes`` (the JAX package's bound, ``glr.py:460-465``).
    """
    nprof, window, block = t_num.shape
    pdtype = torch.uint8 if nprof <= 255 else torch.int32
    nb = -(-nz // block)
    ny, nx = cube_fsf.shape[1:]
    s = ny * nx
    per_spaxel = (2 * nb * window + 2 * nb * block) * 4
    nslab = max(1, -(-s * per_spaxel // max_transient_bytes))
    slab = -(-s // nslab)
    total = nb * block + window - block

    x_all = cube_fsf.reshape(nz, s)
    n_all = norm_fsf.reshape(nz, s)
    correl = torch.empty((nz, s), dtype=torch.float32, device=cube_fsf.device)
    profile = torch.empty((nz, s), dtype=pdtype, device=cube_fsf.device)
    cmin = torch.empty((nz, s), dtype=torch.float32, device=cube_fsf.device)

    def windows(a):  # (slab, Nz) -> (slab, NB, W)
        a = torch.nn.functional.pad(a, (pad_left, total - pad_left - nz))
        return a.unfold(1, window, block)

    for s0 in range(0, s, slab):
        s1 = min(s, s0 + slab)
        xw = windows(x_all[:, s0:s1].T)
        nw = windows(n_all[:, s0:s1].T)
        best = torch.full((s1 - s0, nz), float("-inf"),
                          device=cube_fsf.device)
        low = torch.full((s1 - s0, nz), float("inf"), device=cube_fsf.device)
        arg = torch.zeros((s1 - s0, nz), dtype=pdtype, device=cube_fsf.device)
        for k in range(nprof):
            num = torch.matmul(xw, t_num[k]).reshape(s1 - s0, nb * block)
            den = torch.matmul(nw, t_den[k]).reshape(s1 - s0, nb * block)
            cp = num[:, :nz]
            norm = den[:, :nz]
            norm = torch.where(norm <= 0, float("inf"), torch.sqrt(norm))
            t = cp / norm
            arg = torch.where(t > best, torch.tensor(k, dtype=pdtype,
                                                     device=t.device), arg)
            best = torch.maximum(best, t)
            low = torch.minimum(low, t)
        correl[:, s0:s1] = best.T
        profile[:, s0:s1] = arg.T
        cmin[:, s0:s1] = low.T

    shape = (nz, ny, nx)
    return correl.reshape(shape), profile.reshape(shape), cmin.reshape(shape)
