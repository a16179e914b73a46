"""Scaled-int16 encoders of the session's compact cube files.

Torch ports of the JAX package's two quantizers, run on the tensor's own
device before its copy to the host, so that the copy moves int16 values
(or the (index, value) pairs of the nonzero entries), not float32:

* :func:`encode_i16` is ``origin_tpu.pipeline.wires._encode_i16``: a
  float32 scale ``max(max|x| / 32766, 1e-30)``, where XLA compiles the
  division by the constant into a product with its float32 reciprocal (so
  does the port), and ``q = clip(round_half_even(x / scale), +-32767)``;
* :func:`sparse_i16` is ``_scatter_sparse(..., quant=True)`` of the same
  module: the scale ``max(max|v|, 1e-30) / 32766`` of the nonzero values
  ``v``, computed in float64, the same float32 quantization, and an
  extremum smaller than half a step clamped to +-1 so that it stays in the
  nonzero set.

Division and ``torch.round`` are correctly rounded on the CPU and on CUDA,
so both devices give the JAX functions' bits.  ``scale`` passes a kept
scale instead (a product read back from its file), which gives back the
file's integers exactly (``Quant16``).  The dense encoder works in z-slabs,
so it adds no cube-sized float32 temporary to the device's peak.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["encode_i16", "sparse_i16"]

# channels per slab of encode_i16's passes
SLAB = 256
QMAX = 32767
# the float32 reciprocal that XLA multiplies by for the JAX encoder's
# ``/ 32766.0``
_INV_QSTEP = float(np.float32(1.0 / 32766.0))


def _quantize(x, scale32):
    """``clip(round_half_even(x / scale), +-32767)`` as int16."""
    return torch.clamp(torch.round(x / scale32), -QMAX, QMAX).to(torch.int16)


def abs_max(t):
    """``max|t|`` as a float32 0-d tensor, in z-slabs."""
    t = t.to(torch.float32)
    amax = torch.zeros((), dtype=torch.float32, device=t.device)
    for i in range(0, t.shape[0], SLAB):
        amax = torch.maximum(amax, torch.amax(torch.abs(t[i:i + SLAB])))
    return amax


def i16_scale(amax):
    """The float32 scale (0-d tensor) of :func:`encode_i16` for the
    largest magnitude ``amax``."""
    return torch.clamp(amax * _INV_QSTEP, min=float(np.float32(1e-30)))


def encode_i16(t, scale=None):
    """``(q, scale)``: the int16 tensor ``q`` on ``t``'s device and the
    Python float of the float32 scale, ``t ~ q * scale``."""
    t = t.to(torch.float32)
    starts = range(0, t.shape[0], SLAB)
    if scale is None:
        scale32 = i16_scale(abs_max(t))
        scale = float(scale32)
    else:
        scale32 = torch.tensor(np.float32(scale), device=t.device)
    q = torch.empty(t.shape, dtype=torch.int16, device=t.device)
    for i in starts:
        q[i:i + SLAB] = _quantize(t[i:i + SLAB], scale32)
    return q, scale


def sparse_i16(t, scale=None):
    """``(idx, q, scale)`` of the nonzero entries of ``t`` in ascending
    flat-index order: ``idx`` (int32 while ``t`` has fewer than 2**31
    entries, else int64) and the int16 ``q`` on ``t``'s device, and the
    Python float scale (float64, as the JAX package stores it)."""
    flat = t.reshape(-1)
    (idx,) = torch.nonzero(flat, as_tuple=True)
    return quantize_pairs(idx, flat[idx], flat.numel(), scale)


def quantize_pairs(idx, vals, numel, scale=None):
    """:func:`sparse_i16`'s pairs from the flat indices ``idx`` (ascending)
    and values ``vals`` of the nonzero entries of a cube of ``numel``
    entries."""
    vals = vals.to(torch.float32)
    if numel < 2**31:
        idx = idx.to(torch.int32)
    if scale is None:
        amax = float(torch.amax(torch.abs(vals))) if vals.numel() else 0.0
        scale = max(amax, 1e-30) / 32766.0
    if not vals.numel():
        return (idx, torch.zeros(0, dtype=torch.int16, device=vals.device),
                scale)
    q = _quantize(vals, torch.tensor(np.float32(scale), device=vals.device))
    # an extremum tinier than half a step must not vanish from the nonzero
    # set (consumers enumerate extrema by != 0): clamp it to +-1
    tiny = (q == 0) & (vals != 0)
    q = torch.where(tiny, torch.where(vals > 0, 1, -1).to(torch.int16), q)
    return idx, q, scale
