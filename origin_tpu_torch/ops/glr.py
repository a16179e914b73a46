"""GLR matched-filter test: host profile packing, the spatial FSF stage and
the plain spectral sweep (torch port of :mod:`origin_tpu.ops.glr`).

1. Spatial stage: every channel is correlated with its zero-mean FSF (and
   the weight map with FSF^2 for the norm).  The FSF spectra and the norm
   cube are data-independent (:func:`precompute_spatial`, ``torch.fft``);
   the per-cube convolution is DFT-by-matmul (:func:`glr_spatial_matmul`),
   the plain version of the CUDA kernel
   :func:`origin_tpu_torch.ops.spatial.spatial_fsf`.  A tight-memory
   session computes both per spectral slab with FFTs instead
   (:func:`glr_spatial_chunked`).
2. Spectral stage: each trimmed, normalized profile is a 'same'
   correlation along z, with a running max / argmax / min over the
   dictionary.  :func:`toeplitz_sweep` here is the plain version (unfold +
   matmul against the banded-Toeplitz banks); the CUDA kernel that runs
   on the GPU is :func:`origin_tpu_torch.ops.sweep.spectral_sweep`.

Both plain versions take ``precision="highest"`` (float32 products) or
``"bf16x3"`` (the 3-pass bfloat16 scheme of :mod:`.prec`, split where the
TPU kernels split).

The library entries of the JAX module run on their tensors' device:
:func:`glr_spatial` and :func:`glr_spatial_pre` (``torch.fft``),
:func:`glr_spectral` (the spaxel-major sweep kernel on a GPU,
:func:`origin_tpu_torch.ops.kernels.matched_filter_spectral`) and
:func:`glr_spectral_mxu` (the sweep kernel on a GPU).
:func:`correlation_glr_test` is the host orchestrator, the reference's
``Correlation_GLR_test``, on the device it is given.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..device import resolve_device, set_precision
from .convolve import fft2_shape, fftconvolve2d_same
from .prec import split_and_dot, sqrt_rn

__all__ = [
    "prepare_profiles",
    "pack_profiles_toeplitz",
    "dft_spatial_factors",
    "precompute_spatial",
    "spatial_operands",
    "glr_spatial",
    "glr_spatial_pre",
    "glr_spatial_matmul",
    "glr_spatial_chunked",
    "glr_spectral",
    "glr_spectral_mxu",
    "index_dtype",
    "toeplitz_sweep",
    "correlation_glr_test",
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


def _pack_profiles(prepped, length=None):
    """Stack trimmed profiles into a right-zero-padded (K, L) bank.

    Returns (prof_bank, prof2_bank, centers): profile j of length l_j sits
    in row j, padded with zeros on the right, and its square in
    ``prof2_bank`` (taken before the cast to float32, as the Toeplitz banks
    take it); ``centers[j] = (l_j - 1) // 2`` is the offset of the centred
    'same' correlation.
    """
    k = len(prepped)
    if length is None:
        length = max(len(p) for p, _ in prepped)
    buf = np.zeros((k, length), dtype=np.float32)
    buf2 = np.zeros((k, length), dtype=np.float32)
    centers = []
    for i, (prof, c) in enumerate(prepped):
        buf[i, : len(prof)] = prof
        buf2[i, : len(prof)] = np.asarray(prof) ** 2
        centers.append(int(c))
    return buf, buf2, tuple(centers)


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


def _fsf_kernel(psf):
    """The flipped zero-mean FSF of each channel of a (Nz, P, P) cube."""
    kern = torch.flip(psf, dims=(1, 2))
    return kern - torch.mean(kern, dim=(1, 2), keepdim=True)


def _norm_term(kern, wmap, ny, nx, fshape2):
    """One field's norm cube: the ones (or the weight map ``wmap``)
    correlated with each channel's FSF^2, from one FFT of that image
    broadcast over z."""
    base = (torch.ones((1, ny, nx), dtype=kern.dtype, device=kern.device)
            if wmap is None else wmap[None])
    bf = torch.fft.rfft2(base, s=fshape2)
    k2f = torch.fft.rfft2(kern * kern, s=fshape2)
    full = torch.fft.irfft2(bf * k2f, s=fshape2)
    ph, pw = kern.shape[-2:]
    y0, x0 = (ph - 1) // 2, (pw - 1) // 2
    return full[:, y0 : y0 + ny, x0 : x0 + nx]


def _field_data(cube, wmaps, nf):
    return cube if wmaps is None else cube * wmaps[nf][None]


def precompute_spatial(psfs, wmaps, ny, nx, fshape2):
    """Data-independent part of the spatial stage, computed once per dataset.

    ``psfs`` is (F, Nz, P, P), ``wmaps`` (F, Ny, Nx) or None.  Returns
    (kern_hats, norm_fsf): the (F, Nz, fy, fx//2+1) complex bank of flipped
    zero-mean FSF spectra and the summed (Nz, Ny, Nx) norm cube.
    """
    kern_hats = []
    norm_fsf = None
    for nf in range(psfs.shape[0]):
        kern = _fsf_kernel(psfs[nf])
        kern_hats.append(torch.fft.rfft2(kern, s=fshape2))
        n = _norm_term(kern, None if wmaps is None else wmaps[nf], ny, nx,
                       fshape2)
        norm_fsf = n if norm_fsf is None else norm_fsf + n
    return torch.stack(kern_hats), norm_fsf.contiguous()


def glr_spatial(cube, psfs, wmaps, fshape2):
    """Spatial FSF stage on FFTs: returns (cube_fsf, norm_fsf), each
    (Nz, Ny, Nx).

    ``psfs`` is (F, Nz, P, P), ``wmaps`` (F, Ny, Nx) or None for a single
    field: each (weighted) channel is correlated with its flipped zero-mean
    FSF (:func:`fftconvolve2d_same`), and the norm is the (weighted) ones
    correlated with FSF^2; the fields' terms are summed.
    """
    ny, nx = cube.shape[-2:]
    cube_fsf = norm_fsf = None
    for nf in range(psfs.shape[0]):
        kern = _fsf_kernel(psfs[nf])
        c = fftconvolve2d_same(_field_data(cube, wmaps, nf), kern, fshape2)
        n = _norm_term(kern, None if wmaps is None else wmaps[nf], ny, nx,
                       fshape2)
        cube_fsf = c if cube_fsf is None else cube_fsf + c
        norm_fsf = n if norm_fsf is None else norm_fsf + n
    return cube_fsf.contiguous(), norm_fsf.contiguous()


def glr_spatial_pre(cube, kern_hats, wmaps, psf_shape, fshape2):
    """Spatial stage from the FSF spectra of :func:`precompute_spatial`:
    two cube-sized FFT passes a field.  Returns cube_fsf (Nz, Ny, Nx); the
    norm cube comes from :func:`precompute_spatial`."""
    ny, nx = cube.shape[-2:]
    ph, pw = psf_shape
    y0, x0 = (ph - 1) // 2, (pw - 1) // 2
    cube_fsf = None
    for nf in range(kern_hats.shape[0]):
        cf = torch.fft.rfft2(_field_data(cube, wmaps, nf), s=fshape2)
        full = torch.fft.irfft2(cf * kern_hats[nf], s=fshape2)
        c = full[:, y0 : y0 + ny, x0 : x0 + nx]
        cube_fsf = c if cube_fsf is None else cube_fsf + c
    return cube_fsf.contiguous()


def spatial_operands(psfs, wmaps, ny, nx, fshape2):
    """The matmul spatial stage's operands on ``psfs``' device: the real
    and imaginary parts of the FSF spectra (:func:`precompute_spatial`),
    the DFT factors (:func:`dft_spatial_factors`) and the norm cube.
    Returns (kern_r, kern_i, factors, norm_fsf)."""
    kern_hats, norm_fsf = precompute_spatial(psfs, wmaps, ny, nx, fshape2)
    factors = {k: torch.from_numpy(v).to(psfs.device)
               for k, v in dft_spatial_factors(
                   ny, nx, fshape2, psfs.shape[-2:]).items()}
    return (kern_hats.real.contiguous(), kern_hats.imag.contiguous(),
            factors, norm_fsf)


def glr_spatial_matmul(cube, kern_r, kern_i, wmaps, factors,
                       precision="highest"):
    """Spatial FSF stage as batched matmuls (DFT-by-matmul).

    ``kern_r/kern_i``: (F, Nz, FY, FXr) real/imag parts of the FSF spectra
    from :func:`precompute_spatial`; ``factors`` from
    :func:`dft_spatial_factors`, as tensors.  Returns cube_fsf (Nz, Ny, Nx).

    At ``"highest"`` these are float32 matmuls (cuBLAS on a GPU: the JAX
    package's XLA route).  In ``"bf16x3"`` the chain splits where the TPU
    kernel ``_spatial_kernel`` splits (``pallas_spatial.py:56-79``): the
    factor matrices, the (weighted) data slab, ``zr``/``zi`` after the
    x-DFT, ``pr``/``pi`` after the float32 spectral multiply and
    ``gr``/``gi`` before the inverse x-DFT.  This is the plain version of
    the CUDA kernel :func:`origin_tpu_torch.ops.spatial.spatial_fsf`.

    Each field's pass is one ``glr.field`` span (attribute ``index``, the
    field's), which while tracing is on waits for the device at both ends
    (:func:`origin_tpu_torch.tracing.span`).
    """
    sp, d3 = split_and_dot(precision)
    axr, axi = sp(factors["axr"]), sp(factors["axi"])
    ayr, ayi = sp(factors["ayr"]), sp(factors["ayi"])
    byr, byi = sp(factors["byr"]), sp(factors["byi"])
    cxr, cxi = sp(factors["cxr"]), sp(factors["cxi"])
    cube_fsf = None
    for nf in range(kern_r.shape[0]):
        with tracing.span("glr.field", sync=cube.device, index=nf):
            data = sp(_field_data(cube, wmaps, nf))
            zr = sp(d3(data, axr))  # (z, ny, FXr)
            zi = sp(d3(data, axi))
            del data
            yr = d3(ayr, zr) - d3(ayi, zi)  # (z, FY, FXr)
            yi = d3(ayr, zi) + d3(ayi, zr)
            del zr, zi
            pr = sp(yr * kern_r[nf] - yi * kern_i[nf])
            pi = sp(yr * kern_i[nf] + yi * kern_r[nf])
            del yr, yi
            gr = sp(d3(byr, pr) - d3(byi, pi))  # (z, ny, FXr)
            gi = sp(d3(byr, pi) + d3(byi, pr))
            del pr, pi
            out = d3(gr, cxr) - d3(gi, cxi)
            cube_fsf = out if cube_fsf is None else cube_fsf + out
    return cube_fsf


def glr_spatial_chunked(cube, psfs, wmaps, fshape2, zchunk=512):
    """Memory-bounded spatial stage: (cube_fsf, norm_fsf) slab by slab.

    The JAX package's ``glr_spatial_chunked``: every channel's FSF
    correlation and norm as padded 2-D real FFTs (``torch.fft``), over
    spectral slabs of ``zchunk`` channels, so that no spectra bank of the
    whole cube is held and the transients stay near ``zchunk / Nz`` of the
    whole cube's.  ``psfs`` is (F, Nz, P, P), ``wmaps`` (F, Ny, Nx) or None
    (one field); the fields' terms are summed, each field's slabs in one
    ``glr.field`` span.  Returns two (Nz, Ny, Nx) float32 tensors.
    """
    nz, ny, nx = cube.shape
    ph, pw = psfs.shape[-2:]
    y0, x0 = (ph - 1) // 2, (pw - 1) // 2
    cube_fsf = torch.zeros_like(cube)
    norm_fsf = torch.zeros_like(cube)

    def same(a):
        return a[:, y0 : y0 + ny, x0 : x0 + nx]

    for nf in range(psfs.shape[0]):
        with tracing.span("glr.field", sync=cube.device, index=nf):
            base = (torch.ones((1, ny, nx), dtype=cube.dtype,
                               device=cube.device)
                    if wmaps is None else wmaps[nf][None])
            bf = torch.fft.rfft2(base, s=fshape2)
            for z0 in range(0, nz, zchunk):
                z1 = min(nz, z0 + zchunk)
                kern = torch.flip(psfs[nf, z0:z1], dims=(1, 2))
                kern = kern - torch.mean(kern, dim=(1, 2), keepdim=True)
                data = (cube[z0:z1] if wmaps is None
                        else cube[z0:z1] * wmaps[nf])
                cf = torch.fft.rfft2(data, s=fshape2)
                cf *= torch.fft.rfft2(kern, s=fshape2)
                cube_fsf[z0:z1] += same(torch.fft.irfft2(cf, s=fshape2))
                del cf
                k2f = torch.fft.rfft2(kern * kern, s=fshape2)
                norm_fsf[z0:z1] += same(torch.fft.irfft2(bf * k2f,
                                                         s=fshape2))
    return cube_fsf, norm_fsf


def index_dtype(nprof):
    """dtype of the sweeps' profile indices: uint8 up to 255 profiles, int32 beyond."""
    return torch.uint8 if nprof <= 255 else torch.int32


def toeplitz_sweep(cube_fsf, norm_fsf, t_num, t_den, pad_left, nz,
                   max_transient_bytes=2 << 30, precision="highest"):
    """Plain spectral sweep: unfold + matmul against the Toeplitz banks.

    Inputs are (Nz, Ny, Nx) float32 cubes and the (K, W, block) banks of
    :func:`pack_profiles_toeplitz`; returns (correl, profile_idx,
    correl_min), each (Nz, Ny, Nx).  Profile indices are uint8 for up to
    255 profiles and int32 beyond that; on a tie the first profile wins.
    In ``"bf16x3"`` the input windows and the banks are split, as the TPU
    kernel splits them (``pallas_sweep.py:57-64``).

    The sliding-window view costs ~W/B copies of the cube, so the spaxels
    run in slabs that keep the transient memory near
    ``max_transient_bytes`` (the JAX package's bound, ``glr.py:460-465``).
    """
    sp, d3 = split_and_dot(precision)
    nprof, window, block = t_num.shape
    pdtype = index_dtype(nprof)
    nb = -(-nz // block)
    ny, nx = cube_fsf.shape[1:]
    s = ny * nx
    per_spaxel = (2 * nb * window + 2 * nb * block) * 4
    if precision == "bf16x3":  # the windows' hi and lo halves
        per_spaxel += 4 * nb * window * 4
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
        xw = sp(windows(x_all[:, s0:s1].T))
        nw = sp(windows(n_all[:, s0:s1].T))
        best = torch.full((s1 - s0, nz), float("-inf"),
                          device=cube_fsf.device)
        low = torch.full((s1 - s0, nz), float("inf"), device=cube_fsf.device)
        arg = torch.zeros((s1 - s0, nz), dtype=pdtype, device=cube_fsf.device)
        for k in range(nprof):
            num = d3(xw, sp(t_num[k])).reshape(s1 - s0, nb * block)
            den = d3(nw, sp(t_den[k])).reshape(s1 - s0, nb * block)
            cp = num[:, :nz]
            norm = den[:, :nz]
            norm = torch.where(norm <= 0, float("inf"), sqrt_rn(norm))
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


def glr_spectral(cube_fsf, norm_fsf, prof_bank, prof2_bank, centers, nz):
    """Spectral matched-filter sweep over a (K, L) profile bank, with the
    running max / argmax / min.

    ``cube_fsf`` and ``norm_fsf`` are (Nz, Ny, Nx) float32; ``prof_bank``,
    ``prof2_bank`` and ``centers`` come from :func:`_pack_profiles`.  The
    cubes go to the spaxel-major (S, Nz) layout and back, as in the JAX
    function, around
    :func:`origin_tpu_torch.ops.kernels.matched_filter_spectral`: on a
    CUDA tensor its kernel (``csrc/toeplitz_sweep.cu``, spaxel-major),
    which launches or raises; on a CPU tensor its plain version.  Returns
    (correl, profile_idx, correl_min), each (Nz, Ny, Nx); profile indices
    are uint8 up to 255 profiles and int32 beyond.

    The kernel sums each profile's nonzero span and its plain version
    skips the zero taps; the JAX function multiplies every tap of the
    bank's row, so a NaN or infinite sample facing a profile's zero
    padding makes its statistic NaN where theirs stays finite
    (:func:`~origin_tpu_torch.ops.kernels.matched_filter_spectral`).
    """
    # kernels imports this module for the plain sweep
    from .kernels import matched_filter_spectral

    ny, nx = cube_fsf.shape[1:]
    s = ny * nx
    x = cube_fsf.reshape(nz, s).T.contiguous()
    n = norm_fsf.reshape(nz, s).T.contiguous()
    correl, cmin, pidx = matched_filter_spectral(x, n, prof_bank, prof2_bank,
                                                 centers)
    del x, n

    def back(a):
        return a.T.reshape(nz, ny, nx).contiguous()

    return (back(correl), back(pidx.to(index_dtype(len(centers)))),
            back(cmin))


def glr_spectral_mxu(cube_fsf, norm_fsf, t_num, t_den, pad_left, nz,
                     precision="highest"):
    """Spectral matched-filter sweep over the banded-Toeplitz banks of
    :func:`pack_profiles_toeplitz`.

    :func:`origin_tpu_torch.ops.sweep.spectral_sweep`: on a CUDA tensor
    the sweep kernel of ``precision``, which launches or raises; on a CPU
    tensor the plain :func:`toeplitz_sweep`.  Inputs are (Nz, Ny, Nx);
    returns (correl, profile_idx, correl_min), each (Nz, Ny, Nx); profile
    indices are uint8 up to 255 profiles and int32 beyond.
    """
    # sweep imports this module for the plain sweep
    from .sweep import spectral_sweep

    dev = cube_fsf.device
    t_num, t_den = (torch.as_tensor(t, dtype=torch.float32, device=dev)
                    for t in (t_num, t_den))
    return spectral_sweep(cube_fsf.contiguous(), norm_fsf.contiguous(),
                          t_num.contiguous(), t_den.contiguous(), pad_left,
                          nz, precision=precision)


def correlation_glr_test(cube, fsf, weights, profiles, pcut=1e-8,
                         pmeansub=True, device="cuda"):
    """Full GLR test (the reference's ``Correlation_GLR_test``): the host
    orchestrator around the two device stages.

    ``cube`` is the host (Nz, Ny, Nx) cube, ``fsf`` one (Nz, P, P) PSF
    cube or, with ``weights`` (the per-field weight maps), a list of them
    (a mosaic); ``profiles`` the spectral dictionary.  The spatial stage
    is the DFT-by-matmul chain (:func:`glr_spatial_matmul`, cuBLAS on a
    GPU), the spectral stage :func:`glr_spectral_mxu` (one launch of the
    sweep kernel on a GPU), both at ``"highest"`` whatever
    ``ORIGIN_TPU_PRECISION`` says, as the JAX function runs them.  They
    run on ``device``: ``"cuda"`` raises without a GPU, ``"cpu"`` runs the
    plain versions when the caller asks for it.

    Returns writable numpy arrays (correl, profile, correl_min).
    """
    dev = resolve_device(device)
    set_precision()

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    cube = np.asarray(cube, dtype=np.float32)
    nz, ny, nx = cube.shape
    if weights is None:
        psfs = np.asarray(fsf, dtype=np.float32)
        if psfs.ndim == 3:
            psfs = psfs[None]
        wmaps = None
    else:
        psfs = np.stack([np.asarray(p, dtype=np.float32) for p in fsf])
        wmaps = up(np.stack([np.asarray(w, dtype=np.float32)
                             for w in weights]))

    kern_r, kern_i, factors, norm_fsf = spatial_operands(
        up(psfs), wmaps, ny, nx, fft2_shape((ny, nx), psfs.shape[-2:]))
    cube_fsf = glr_spatial_matmul(up(cube), kern_r, kern_i, wmaps, factors)
    del kern_r, kern_i, factors

    prepped = prepare_profiles(profiles, pcut=pcut, pmeansub=pmeansub)
    t_num, t_den, pad_left, _ = pack_profiles_toeplitz(prepped,
                                                       block=min(128, nz))
    out = glr_spectral_mxu(cube_fsf, norm_fsf, up(t_num), up(t_den),
                           pad_left, nz)
    return tuple(t.cpu().numpy() for t in out)
