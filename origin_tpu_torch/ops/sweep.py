"""GLR spectral sweep: the CUDA kernels and their dispatch.

:func:`spectral_sweep` is the step-05 entry point.  A CPU tensor goes to
the plain version (:func:`origin_tpu_torch.ops.glr.toeplitz_sweep`); a
CUDA tensor goes to a hand-written kernel that replaces the TPU kernel
``_sweep_kernel`` (``origin_tpu/ops/pallas_sweep.py``): at
``precision="highest"`` ``csrc/toeplitz_sweep.cu`` (float32 FMAs over each
profile's taps), in ``"bf16x3"`` ``csrc/sweep_bf16x3.cu`` (a banded
matmul on the bf16 tensor cores).  There is no fallback between them: a
failed build or launch raises.  :func:`launch_sweep` is the launch that
the spaxel-major entries of :mod:`origin_tpu_torch.ops.kernels` share.

Both kernels read the FSF-convolved cube and the norm cube in their own
(Nz, Ny*Nx) layout and take the taps of each profile from column 0 of
the banded-Toeplitz banks (:func:`sweep_taps`); the bf16x3 kernel takes
them as the 16 x 16 blocks of the band (:func:`toeplitz_blocks`), split
(:func:`bf16x3_blocks`).
"""

from __future__ import annotations

import ctypes

import torch

from .glr import toeplitz_sweep
from .prec import check_precision, split_bf16

__all__ = ["spectral_sweep", "sweep_taps", "taps_extent", "toeplitz_blocks",
           "bf16x3_blocks", "launch_sweep", "launch_sweep_bf16x3",
           "check_tensor"]

#: channels of a group and depth of a k-step of the bf16x3 kernel: the
#: tensor cores' m16n16k16 fragment
BAND_BLOCK = 16


def sweep_taps(t_num, t_den):
    """Direct-form taps from the (K, W, block) banded-Toeplitz banks.

    Column 0 of bank k holds profile k at rows [start_k, start_k + len_k)
    of its first ``reach = W - block + 1`` rows; every later column is the
    same column shifted down by its index.  Returns ``(taps_num, taps_den,
    start, length)``: (K, reach) float32 taps (bit-identical to the bank
    entries) and (K,) int32 extents of their nonzero span, computed on the
    banks' device without a host sync.
    """
    nprof, window, block = t_num.shape
    reach = window - block + 1
    return taps_extent(t_num[:, :reach, 0].contiguous(),
                       t_den[:, :reach, 0].contiguous())


def taps_extent(taps_num, taps_den):
    """``(taps_num, taps_den, start, length)``: (K,) int32 extents of the
    nonzero span of each row of the (K, reach) taps, on their device."""
    reach = taps_num.shape[1]
    nonzero = (taps_num != 0) | (taps_den != 0)
    first = torch.argmax(nonzero.to(torch.int32), dim=1)
    last = reach - 1 - torch.argmax(nonzero.flip(1).to(torch.int32), dim=1)
    length = torch.clamp(last - first + 1, min=0)
    return (taps_num, taps_den, first.to(torch.int32).contiguous(),
            length.to(torch.int32).contiguous())


def toeplitz_blocks(taps, start, length):
    """The 16 x 16 blocks of each profile's Toeplitz band.

    Over groups of 16 output channels, the product ``out[t] = sum_r
    taps[r - t] * window[r]`` cuts into 16 x 16 blocks, and block (ti, rj)
    depends only on ``d = rj - ti``: ``D[k, d, a, b] = taps[k, 16 d + b -
    a]``, 0 where that index leaves [0, reach).  ``taps`` is (K, reach)
    float32, ``start`` and ``length`` the (K,) int32 extents of
    :func:`taps_extent`.  Returns ``(blocks, d_first, d_last)``: (K, ND,
    16, 16) float32 blocks for d < ND = (reach + 14) // 16 + 1, each entry
    a tap (bit for bit) or 0, and the (K,) int32 first and last d whose
    block meets the span [start, start + length): ``start // 16`` and
    ``(start + length + 14) // 16``.  On the taps' device, no host sync.
    """
    nprof, reach = taps.shape
    nd = (reach + 14) // BAND_BLOCK + 1
    idx = torch.arange(BAND_BLOCK, device=taps.device)
    j = (BAND_BLOCK * torch.arange(nd, device=taps.device)[:, None, None]
         + idx[None, None, :] - idx[None, :, None])  # (ND, 16, 16)
    inside = (j >= 0) & (j < reach)
    blocks = torch.where(inside, taps[:, j.clamp(0, reach - 1)], 0.0)
    d_first = torch.div(start, BAND_BLOCK, rounding_mode="floor")
    d_last = torch.div(start + length + BAND_BLOCK - 2, BAND_BLOCK,
                       rounding_mode="floor")
    return (blocks, d_first.to(torch.int32).contiguous(),
            d_last.to(torch.int32).contiguous())


def bf16x3_blocks(taps_num, taps_den, start, length):
    """The bf16x3 kernel's operand: ``(blocks, d_first, d_last)`` with
    (K, ND, 4, 16, 16) bfloat16 blocks, the ``split_bf16`` halves of
    :func:`toeplitz_blocks` of the num and the den taps in the order num
    hi, num lo, den hi, den lo.  The banks are split once per launch, as
    the TPU kernel splits them once per call (``pallas_sweep.py:58-59``).
    """
    bnum, d_first, d_last = toeplitz_blocks(taps_num, start, length)
    bden, _, _ = toeplitz_blocks(taps_den, start, length)
    planes = torch.stack([*split_bf16(bnum), *split_bf16(bden)], dim=2)
    return planes.to(torch.bfloat16).contiguous(), d_first, d_last


def check_tensor(name, t, dtype, shape, device):
    """Raise unless ``t`` has this device, dtype and shape and is
    contiguous: what a kernel's wrapper checks before a launch."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _launch(name, args):
    """``<name>_launch(*args, stream)`` of ``csrc/<name>.cu`` (built on
    first use) on the current stream of the first argument's device: each
    tensor passed as its data pointer, each other argument as a C int.
    Raises on a failed launch."""
    from .build import load_library

    lib = load_library(name)
    fn = getattr(lib, f"{name}_launch")
    fn.argtypes = [ctypes.c_void_p if torch.is_tensor(a) else ctypes.c_int
                   for a in args] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = args[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(a.data_ptr() if torch.is_tensor(a) else int(a)
                   for a in args), stream)
    if err != 0:
        what = getattr(lib, f"{name}_error_string")
        what.argtypes, what.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{what(err).decode()} (cudaError {err})")


def _check_extent(taps, pad_left, nz, s):
    reach = taps[0].shape[1]
    if not 0 <= int(pad_left) < reach:
        raise ValueError(f"pad_left={pad_left} outside the taps' reach")
    if nz * s >= 2 ** 31:
        raise ValueError("sweep: cube exceeds 2^31 voxels")


def launch_sweep(x, n, taps, pad_left, profile, correl, cmin, nz, s,
                 spaxel_major=False):
    """Launch the float32 sweep kernel on the current stream.

    ``taps`` is ``(taps_num, taps_den, start, length)`` of
    :func:`taps_extent`; ``x``, ``n`` and the three outputs are (nz, s),
    or (s, nz) when ``spaxel_major``.  Raises on a failed launch.
    """
    _check_extent(taps, pad_left, nz, s)
    nprof, reach = taps[0].shape
    _launch("toeplitz_sweep",
            (x, n, *taps, correl, profile, cmin, nz, s, nprof, reach,
             pad_left, profile.element_size(), 0, int(spaxel_major)))


def launch_sweep_bf16x3(x, n, taps, pad_left, profile, correl, cmin, nz, s):
    """Launch the bf16x3 sweep kernel on the current stream: the same
    arguments as :func:`launch_sweep` in the cube's (nz, s) layout; the
    taps go to the kernel as :func:`bf16x3_blocks`."""
    _check_extent(taps, pad_left, nz, s)
    blocks, d_first, d_last = bf16x3_blocks(*taps)
    nprof, nd = blocks.shape[:2]
    _launch("sweep_bf16x3",
            (x, n, blocks, d_first, d_last, correl, profile, cmin, nz, s,
             nprof, nd, pad_left, profile.element_size()))


def spectral_sweep(cube_fsf, norm_fsf, t_num, t_den, pad_left, nz,
                   precision="highest"):
    """GLR spectral sweep with running max / argmax / min over profiles.

    Same signature and outputs as ``toeplitz_sweep_pallas``: (Nz, Ny, Nx)
    float32 cubes and the (K, W, block) float32 banks in; ``(correl,
    profile, correl_min)`` out, each (Nz, Ny, Nx), profile indices uint8
    for K <= 255 and int32 above; ``precision`` ``"highest"`` or
    ``"bf16x3"``.  On a CPU tensor this is the plain version; on a CUDA
    tensor it launches the kernel of that precision and counts the launch
    in ``spectral_sweep.launches`` (``highest``) or
    ``spectral_sweep.launches_bf16x3``.

    Where the kernels and the TPU kernel ``_sweep_kernel`` differ is the
    footprint of a NaN or infinite sample, which the zero taps that a
    product multiplies decide:

    - the TPU kernel and the plain version multiply the zero taps of
      their (W, block) window, so the sample makes their statistic NaN
      over the window of its 128-channel block;
    - the float32 kernel sums each profile's nonzero span only: NaN in the
      sample's reach, finite elsewhere in that window;
    - the bf16x3 kernel multiplies whole 16 x 16 blocks of the band: NaN
      in every channel z whose group ``G = z // 16`` has a block of some
      profile k over the sample, i.e. samples in ``[16 (G + d_first_k) -
      pad_left, 16 (G + d_last_k + 1) - pad_left)`` (:func:`toeplitz_blocks`).
      That covers the reach and can pass the plain version's window by
      up to one block at a block's last group.

    ``tests/test_torch_gpu.py:_hold`` pins each rule.  The footprints come
    from the tilings, not from the statistic, and the engine zero-fills
    non-finite voxels before step 05 (``pipeline/engine.py:_fill_cube``),
    so the main path never feeds such a sample.
    """
    check_precision(precision)
    dev = cube_fsf.device
    if dev.type == "cpu":
        return toeplitz_sweep(cube_fsf, norm_fsf, t_num, t_den, pad_left, nz,
                              precision=precision)
    if dev.type != "cuda":
        raise ValueError(f"spectral_sweep: unsupported device {dev}")

    nprof, window, block = t_num.shape
    ny, nx = cube_fsf.shape[1:]
    s = ny * nx
    shape = (nz, ny, nx)
    check_tensor("cube_fsf", cube_fsf, torch.float32, shape, dev)
    check_tensor("norm_fsf", norm_fsf, torch.float32, shape, dev)
    check_tensor("t_num", t_num, torch.float32, (nprof, window, block), dev)
    check_tensor("t_den", t_den, torch.float32, (nprof, window, block), dev)

    pdtype = torch.uint8 if nprof <= 255 else torch.int32
    correl = torch.empty(shape, dtype=torch.float32, device=dev)
    profile = torch.empty(shape, dtype=pdtype, device=dev)
    cmin = torch.empty(shape, dtype=torch.float32, device=dev)
    args = (cube_fsf, norm_fsf, sweep_taps(t_num, t_den), pad_left, profile,
            correl, cmin, nz, s)
    if precision == "bf16x3":
        launch_sweep_bf16x3(*args)
        spectral_sweep.launches_bf16x3 += 1
    else:
        launch_sweep(*args)
        spectral_sweep.launches += 1
    return correl, profile, cmin


#: kernel launches since the last reset (plain integers), per precision
spectral_sweep.launches = 0
spectral_sweep.launches_bf16x3 = 0
