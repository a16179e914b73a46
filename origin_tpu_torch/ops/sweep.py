"""GLR spectral sweep: the CUDA kernel and its dispatch.

:func:`spectral_sweep` is the step-05 entry point.  A CPU tensor goes to
the plain version (:func:`origin_tpu_torch.ops.glr.toeplitz_sweep`); a
CUDA tensor goes to the hand-written kernel ``csrc/toeplitz_sweep.cu``,
which replaces the TPU kernel ``_sweep_kernel``
(``origin_tpu/ops/pallas_sweep.py``), at ``precision="highest"`` or in
its ``"bf16x3"`` form.  There is no fallback between the two: a failed
build or launch raises.  :func:`launch_sweep` is the launch that the
spaxel-major entries of :mod:`origin_tpu_torch.ops.kernels` share.

The kernel reads the FSF-convolved cube and the norm cube in their own
(Nz, Ny*Nx) layout and takes the taps of each profile from column 0 of
the banded-Toeplitz banks (:func:`sweep_taps`).
"""

from __future__ import annotations

import ctypes

import torch

from .glr import toeplitz_sweep
from .prec import check_precision

__all__ = ["spectral_sweep", "sweep_taps", "taps_extent", "launch_sweep",
           "check_tensor"]


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


def _library():
    from .build import load_library

    lib = load_library("toeplitz_sweep")
    if not getattr(lib, "_origin_typed", False):
        fn = lib.toeplitz_sweep_launch
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.toeplitz_sweep_error_string.argtypes = [ctypes.c_int]
        lib.toeplitz_sweep_error_string.restype = ctypes.c_char_p
        lib._origin_typed = True
    return lib


def launch_sweep(x, n, taps, pad_left, profile, correl, cmin, nz, s,
                 precision="highest", spaxel_major=False):
    """Launch the sweep kernel on the current stream.

    ``taps`` is ``(taps_num, taps_den, start, length)`` of
    :func:`taps_extent`; ``x``, ``n`` and the three outputs are (nz, s),
    or (s, nz) when ``spaxel_major``.  Raises on a failed launch.
    """
    taps_num, taps_den, start, length = taps
    nprof, reach = taps_num.shape
    if not 0 <= int(pad_left) < reach:
        raise ValueError(f"pad_left={pad_left} outside the taps' reach")
    if nz * s >= 2 ** 31:
        raise ValueError("sweep: cube exceeds 2^31 voxels")
    lib = _library()
    dev = x.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.toeplitz_sweep_launch(
            x.data_ptr(), n.data_ptr(), taps_num.data_ptr(),
            taps_den.data_ptr(), start.data_ptr(), length.data_ptr(),
            correl.data_ptr(), profile.data_ptr(), cmin.data_ptr(),
            int(nz), int(s), int(nprof), int(reach), int(pad_left),
            profile.element_size(), int(precision == "bf16x3"),
            int(spaxel_major), stream,
        )
    if err != 0:
        msg = lib.toeplitz_sweep_error_string(err).decode()
        raise RuntimeError(f"toeplitz_sweep kernel launch failed: {msg} "
                           f"(cudaError {err})")


def spectral_sweep(cube_fsf, norm_fsf, t_num, t_den, pad_left, nz,
                   precision="highest"):
    """GLR spectral sweep with running max / argmax / min over profiles.

    Same signature and outputs as ``toeplitz_sweep_pallas``: (Nz, Ny, Nx)
    float32 cubes and the (K, W, block) float32 banks in; ``(correl,
    profile, correl_min)`` out, each (Nz, Ny, Nx), profile indices uint8
    for K <= 255 and int32 above; ``precision`` ``"highest"`` or
    ``"bf16x3"``.  On a CPU tensor this is the plain version; on a CUDA
    tensor it launches the kernel and counts the launch in
    ``spectral_sweep.launches`` (``highest``) or
    ``spectral_sweep.launches_bf16x3``.

    Where the kernel and the TPU kernel ``_sweep_kernel`` differ: the
    kernel sums each profile's nonzero span only, while the TPU kernel and
    the plain version also multiply the zero taps of their (W, block)
    window.  So a NaN or infinite sample inside that window but outside a
    profile's span makes their statistic NaN where the kernel's stays
    finite (``tests/test_torch_gpu.py:_hold`` pins where).  That wider
    footprint comes from the TPU kernel's block tiling, not from the
    statistic, and the engine zero-fills non-finite voxels before step 05
    (``pipeline/engine.py:_derive_inputs``), so the main path never feeds
    such a sample.
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
    launch_sweep(cube_fsf, norm_fsf, sweep_taps(t_num, t_den), pad_left,
                 profile, correl, cmin, nz, s, precision=precision)
    if precision == "bf16x3":
        spectral_sweep.launches_bf16x3 += 1
    else:
        spectral_sweep.launches += 1
    return correl, profile, cmin


#: kernel launches since the last reset (plain integers), per precision
spectral_sweep.launches = 0
spectral_sweep.launches_bf16x3 = 0
