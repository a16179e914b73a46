"""The spaxel-major GLR sweeps (port of ``origin_tpu.ops.pallas_kernels``).

Two public entry points that compute the spectral sweep of
:func:`origin_tpu_torch.ops.sweep.spectral_sweep` on spaxel-major (S, Nz)
inputs, each with the input convention of its TPU kernel:

- :func:`matched_filter_spectral` replaces ``_mf_kernel``: the profiles as
  a right-zero-padded (K, L) bank with their 'same' ``centers``, applied
  by direct shift-accumulate over each profile's nonzero taps;
- :func:`banded_matmul_spectral` replaces ``_banded_kernel``: the (K, W,
  B) banded-Toeplitz banks with their shared ``pad_left``.

Both return ``(correl, correl_min, profile_idx)``, each (S, Nz), the
indices int32, in the order of the JAX entries.  On a CUDA tensor each
launches the spaxel-major form of the sweep kernel
(``csrc/toeplitz_sweep.cu``) and counts the launch in its ``launches``;
on a CPU tensor each runs its plain version.  Neither is on the step-05
path: the JAX package keeps both as reference kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from .glr import toeplitz_sweep
from .prec import sqrt_rn
from .sweep import check_tensor, launch_sweep, sweep_taps

__all__ = ["matched_filter_spectral", "banded_matmul_spectral",
           "matched_filter_plain", "banded_matmul_plain", "mf_taps"]


def _spaxel_inputs(x, n):
    s, nz = x.shape
    for name, t in (("x", x), ("n", n)):
        check_tensor(name, t, torch.float32, (s, nz), x.device)
    return s, nz


def _outputs(s, nz, dev):
    return (torch.empty((s, nz), dtype=torch.float32, device=dev),
            torch.empty((s, nz), dtype=torch.float32, device=dev),
            torch.empty((s, nz), dtype=torch.int32, device=dev))


def matched_filter_plain(x, n, prof, prof2, centers):
    """Plain version of :func:`matched_filter_spectral`, ``_mf_kernel``'s
    arithmetic: per profile, shift-accumulate over the taps that are not
    both zero, then the running max / argmax / min."""
    prof, prof2 = prof.cpu(), prof2.cpu()  # read tap by tap
    s, nz = x.shape
    length = prof.shape[1]
    left = max(centers)
    right = max(length - 1 - c for c in centers)
    xp = torch.nn.functional.pad(x, (left, right))
    np_ = torch.nn.functional.pad(n, (left, right))
    correl = torch.full((s, nz), float("-inf"), device=x.device)
    cmin = torch.full((s, nz), float("inf"), device=x.device)
    pidx = torch.zeros((s, nz), dtype=torch.int32, device=x.device)
    for k, c in enumerate(centers):
        num = torch.zeros((s, nz), device=x.device)
        den = torch.zeros((s, nz), device=x.device)
        for j in range(length):
            w, w2 = float(prof[k, j]), float(prof2[k, j])
            if w == 0.0 and w2 == 0.0:
                continue
            lo = left + j - c  # out[z] reads in[z + j - c]
            num = num + w * xp[:, lo:lo + nz]
            den = den + w2 * np_[:, lo:lo + nz]
        norm = torch.where(den <= 0, float("inf"), sqrt_rn(den))
        t = num / norm
        pidx = torch.where(t > correl, k, pidx)
        correl = torch.maximum(correl, t)
        cmin = torch.minimum(cmin, t)
    return correl, cmin, pidx


def banded_matmul_plain(x, n, t_num, t_den, pad_left, nz):
    """Plain version of :func:`banded_matmul_spectral`: the plain sweep
    :func:`toeplitz_sweep` on the transposed inputs."""
    s = x.shape[0]
    c, p, m = toeplitz_sweep(x.T.reshape(nz, s, 1), n.T.reshape(nz, s, 1),
                             t_num, t_den, pad_left, nz)
    back = lambda a: a.reshape(nz, s).T.contiguous()
    return back(c), back(m), back(p).to(torch.int32)


def mf_taps(prof_bank, prof2_bank, centers):
    """The sweep kernel's taps for a (K, L) profile bank, built on the host.

    Row k holds ``prof_bank[k]`` (``prof2_bank[k]`` in the den taps) from
    column ``pad_left - centers[k]`` with ``pad_left = max(centers)``, the
    convention of the Toeplitz banks (``glr.pack_profiles_toeplitz``), cut
    to the columns ``[lo, hi)`` that some profile's nonzero span uses.
    Returns ``((taps_num, taps_den, start, length), pad_left - lo)``: the
    (K, hi - lo) float32 taps, bit-identical to the bank entries, the (K,)
    int32 extents of each row's span (as ``sweep.taps_extent`` gives them;
    0 for a row without a nonzero tap) and the pad of the cut taps, all
    numpy.
    """
    prof, prof2 = (torch.as_tensor(a, dtype=torch.float32).cpu().numpy()
                   for a in (prof_bank, prof2_bank))
    length = prof.shape[1]
    pad_left = max(centers)
    nonzero = (prof != 0) | (prof2 != 0)
    used = nonzero.any(axis=1)
    first = np.argmax(nonzero, axis=1)
    last = length - np.argmax(nonzero[:, ::-1], axis=1)  # one past the span
    col = pad_left - np.asarray(centers) + first  # column of each span
    lo = int(np.min(col[used], initial=pad_left))
    hi = int(np.max((col + last - first)[used], initial=pad_left + 1))
    taps = np.zeros((2, prof.shape[0], hi - lo), np.float32)
    start = np.where(used, col - lo, 0).astype(np.int32)
    span = np.where(used, last - first, 0).astype(np.int32)
    for k in np.flatnonzero(used):
        cut = slice(start[k], start[k] + span[k])
        taps[0, k, cut] = prof[k, first[k]:last[k]]
        taps[1, k, cut] = prof2[k, first[k]:last[k]]
    return (taps[0], taps[1], start, span), pad_left - lo


def _upload_taps(taps, dev):
    """:func:`mf_taps`'s taps and extents on ``dev``, in one asynchronous
    copy from pinned memory."""
    taps_num, taps_den, start, length = taps
    nprof, reach = taps_num.shape
    m = nprof * reach
    host = torch.from_numpy(np.concatenate(
        [taps_num.ravel().view(np.int32), taps_den.ravel().view(np.int32),
         start, length])).pin_memory()
    buf = host.to(dev, non_blocking=True)
    f = buf[:2 * m].view(torch.float32)
    return (f[:m].view(nprof, reach), f[m:].view(nprof, reach),
            buf[2 * m:2 * m + nprof], buf[2 * m + nprof:])


def matched_filter_spectral(x, n, prof_bank, prof2_bank, centers):
    """Fused spectral matched filter over a (K, L) profile bank.

    ``x``, ``n``: (S, Nz) float32, spaxel-major; ``prof_bank``,
    ``prof2_bank``: (K, L) right-zero-padded trimmed profiles and their
    squares (``origin_tpu.ops.glr._pack_profiles``); ``centers``: the
    'same' offset of each profile.  Returns ``(correl, correl_min,
    profile_idx)`` of shape (S, Nz).

    Where the kernel and ``_mf_kernel`` differ: ``_mf_kernel`` and the
    plain version skip every tap that is zero in both banks, the kernel
    sums each profile's span from its first to its last nonzero tap.  The
    two agree for profiles without zero taps inside their span (all the
    dictionaries'); with one, a NaN or infinite sample facing it makes the
    kernel's statistic NaN where theirs stays finite.  The engine
    zero-fills non-finite voxels before step 05, and neither entry is on
    its path.
    """
    dev = x.device
    s, nz = _spaxel_inputs(x, n)
    centers = tuple(int(c) for c in centers)
    if dev.type == "cpu":
        return matched_filter_plain(
            x, n, torch.as_tensor(prof_bank, dtype=torch.float32),
            torch.as_tensor(prof2_bank, dtype=torch.float32), centers)
    if dev.type != "cuda":
        raise ValueError(f"matched_filter_spectral: unsupported device {dev}")
    taps, pad_left = mf_taps(prof_bank, prof2_bank, centers)
    correl, cmin, pidx = _outputs(s, nz, dev)
    launch_sweep(x, n, _upload_taps(taps, dev), pad_left, pidx, correl, cmin,
                 nz, s, spaxel_major=True)
    matched_filter_spectral.launches += 1
    return correl, cmin, pidx


def banded_matmul_spectral(x, n, t_num, t_den, pad_left, nz):
    """Banded-Toeplitz spectral sweep on spaxel-major inputs.

    ``x``, ``n``: (S, Nz) float32; ``t_num``, ``t_den``: the (K, W, B)
    banks of :func:`origin_tpu_torch.ops.glr.pack_profiles_toeplitz` with
    their shared left pad ``pad_left``.  Returns ``(correl, correl_min,
    profile_idx)`` of shape (S, Nz).  The TPU kernel seeds its running
    max / min with profile 0's statistic and this port with -inf / +inf;
    the two agree, NaN included (``tests/test_torch_kernels.py``).

    Where the kernel and ``_banded_kernel`` differ: the kernel sums each
    profile's nonzero span only, while the TPU kernel and the plain
    version multiply every tap of their (W, block) window, zeros
    included.  So a NaN or infinite sample inside that window but outside
    a profile's span makes their statistic NaN where the kernel's stays
    finite (``tests/test_torch_gpu.py:_hold`` pins where).  That footprint
    comes from the TPU kernel's block tiling; the engine zero-fills
    non-finite voxels before step 05, and this entry is on no step's path.
    """
    dev = x.device
    s, nz_x = _spaxel_inputs(x, n)
    if nz_x != nz:
        raise ValueError(f"banded_matmul_spectral: x has {nz_x} channels, "
                         f"nz={nz}")
    t_num = torch.as_tensor(t_num, dtype=torch.float32, device=dev)
    t_den = torch.as_tensor(t_den, dtype=torch.float32, device=dev)
    if dev.type == "cpu":
        return banded_matmul_plain(x, n, t_num, t_den, pad_left, nz)
    if dev.type != "cuda":
        raise ValueError(f"banded_matmul_spectral: unsupported device {dev}")
    correl, cmin, pidx = _outputs(s, nz, dev)
    launch_sweep(x, n, sweep_taps(t_num.contiguous(), t_den.contiguous()),
                 pad_left, pidx, correl, cmin, nz, s, spaxel_major=True)
    banded_matmul_spectral.launches += 1
    return correl, cmin, pidx


#: kernel launches since the last reset (plain integers)
matched_filter_spectral.launches = 0
banded_matmul_spectral.launches = 0
