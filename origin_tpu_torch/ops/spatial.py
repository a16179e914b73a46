"""GLR spatial FSF stage: the CUDA kernel and its dispatch.

:func:`spatial_fsf` is the step-05 entry point of the bf16x3 mode.  A CPU
tensor goes to the plain version
(:func:`origin_tpu_torch.ops.glr.glr_spatial_matmul`); a CUDA tensor goes
to the hand-written kernel ``csrc/spatial_fsf.cu``, which replaces the TPU
kernel ``_spatial_kernel`` (``origin_tpu/ops/pallas_spatial.py``).  There
is no fallback between the two: a failed build or launch raises.

:func:`spatial_kernel_admits` is the JAX package's rule for taking the
fused kernel (``spatial_pallas_fits``, a 12 MiB VMEM budget), copied so
that the port takes the same route on the same field.
"""

from __future__ import annotations

import ctypes

import torch

from .. import tracing
from .glr import glr_spatial_matmul
from .prec import check_precision
from .sweep import check_tensor

__all__ = ["spatial_fsf", "spatial_kernel_admits"]

FACTORS = ("axr", "axi", "ayr", "ayi", "byr", "byi", "cxr", "cxi")

#: dynamic shared memory a block may use on Hopper (227 KB)
SMEM_LIMIT = 232448

_VMEM_BUDGET = 12 << 20


def _round_up(x, m):
    return -(-x // m) * m


def _vmem_bytes(zt, ny, nx, fy, fxr):
    """``origin_tpu/ops/pallas_spatial.py:_vmem_bytes``: the TPU kernel's
    double-buffered VMEM footprint of one grid step."""
    nyp, nxp = _round_up(ny, 8), _round_up(nx, 128)
    fyp, fxp = _round_up(fy, 8), _round_up(fxr, 128)
    blocks = zt * (2 * nyp * nxp + 2 * fyp * fxp)
    fac = 2 * (nxp * fxp + fyp * nyp + nyp * fyp + fxp * nxp)
    transients = 12 * max(nyp, fyp) * fxp
    return 4 * (2 * blocks + fac + transients)


def spatial_kernel_admits(ny, nx, fy, fxr):
    """Whether the JAX package would run its fused spatial kernel on this
    field (``spatial_pallas_fits``); the engine then runs this port's."""
    return _vmem_bytes(1, ny, nx, fy, fxr) <= _VMEM_BUDGET


def _library():
    from .build import load_library

    lib = load_library("spatial_fsf")
    if not getattr(lib, "_origin_typed", False):
        fn = lib.spatial_fsf_launch
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.spatial_fsf_smem_bytes.argtypes = [ctypes.c_int] * 4
        lib.spatial_fsf_smem_bytes.restype = ctypes.c_longlong
        lib.spatial_fsf_error_string.argtypes = [ctypes.c_int]
        lib.spatial_fsf_error_string.restype = ctypes.c_char_p
        lib._origin_typed = True
    return lib


def _tile_columns(lib, ny, fy, x3):
    """The widest kx tile whose two shared buffers fit one block."""
    for tk in (32, 16, 8, 4, 2):
        if lib.spatial_fsf_smem_bytes(ny, fy, tk, x3) <= SMEM_LIMIT:
            return tk
    raise ValueError(f"spatial_fsf: a ({ny}, {fy}) field does not fit "
                     f"{SMEM_LIMIT} bytes of shared memory")


def spatial_fsf(cube, kern_r, kern_i, wmaps, factors, precision="highest"):
    """Spatial FSF stage, the fields summed.

    Same arguments and result as :func:`glr_spatial_matmul`: ``cube``
    (Nz, Ny, Nx) float32, ``kern_r/kern_i`` (F, Nz, FY, FXr), optional
    ``wmaps`` (F, Ny, Nx), ``factors`` the dict of
    :func:`origin_tpu_torch.ops.glr.dft_spatial_factors` as tensors.  On a
    CPU tensor this is the plain version; on a CUDA tensor it launches the
    kernel once per field (each launch counted in
    ``spatial_fsf.launches``) and sums the fields in order, as
    ``glr_spatial_pallas`` does; each field's launch and sum is one
    ``glr.field`` span, as in :func:`glr_spatial_matmul`.
    """
    check_precision(precision)
    dev = cube.device
    if dev.type == "cpu":
        return glr_spatial_matmul(cube, kern_r, kern_i, wmaps, factors,
                                  precision=precision)
    if dev.type != "cuda":
        raise ValueError(f"spatial_fsf: unsupported device {dev}")

    nfields, nz, fy, fxr = kern_r.shape
    ny, nx = cube.shape[1:]
    f32 = torch.float32
    check_tensor("cube", cube, f32, (nz, ny, nx), dev)
    check_tensor("kern_r", kern_r, f32, (nfields, nz, fy, fxr), dev)
    check_tensor("kern_i", kern_i, f32, (nfields, nz, fy, fxr), dev)
    if wmaps is not None:
        check_tensor("wmaps", wmaps, f32, (nfields, ny, nx), dev)
    shapes = dict(axr=(nx, fxr), axi=(nx, fxr), ayr=(fy, ny), ayi=(fy, ny),
                  byr=(ny, fy), byi=(ny, fy), cxr=(fxr, nx), cxi=(fxr, nx))
    for name in FACTORS:
        check_tensor(name, factors[name], f32, shapes[name], dev)
    if nz * ny * nx >= 2 ** 31 or nz * fy * fxr >= 2 ** 31:
        raise ValueError("spatial_fsf: cube exceeds 2^31 elements")

    lib = _library()
    x3 = int(precision == "bf16x3")
    tk = _tile_columns(lib, ny, fy, x3)
    out = None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for f in range(nfields):
            with tracing.span("glr.field", sync=dev, index=f):
                o = torch.empty((nz, ny, nx), dtype=f32, device=dev)
                w = None if wmaps is None else wmaps[f].data_ptr()
                err = lib.spatial_fsf_launch(
                    cube.data_ptr(), w, kern_r[f].data_ptr(),
                    kern_i[f].data_ptr(),
                    *(factors[name].data_ptr() for name in FACTORS),
                    o.data_ptr(), nz, ny, nx, fy, fxr, tk, x3, stream)
                if err != 0:
                    msg = lib.spatial_fsf_error_string(err).decode()
                    raise RuntimeError(f"spatial_fsf kernel launch failed: "
                                       f"{msg} (cudaError {err})")
                spatial_fsf.launches += 1
                out = o if out is None else out + o
    return out


#: kernel launches since the last reset (a plain integer)
spatial_fsf.launches = 0
