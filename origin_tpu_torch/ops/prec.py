"""Matmul precision of the GLR kernels (port of ``origin_tpu.ops.pallas_prec``).

Two modes, named by a string:

- ``"highest"``: float32 products and sums;
- ``"bf16x3"``: each float32 operand ``a`` is split into bfloat16 halves,
  ``a ~ hi + lo`` (:func:`split_bf16`), and ``a @ b ~ hi_a@hi_b +
  hi_a@lo_b + lo_a@hi_b``, the dropped ``lo@lo`` term being O(eps^2):
  about 1e-5 relative through the GLR chains.  A product of two bfloat16
  values is exact in float32, so the plain version here forms the three
  passes as float32 matmuls of the bfloat16-valued operands, which is what
  a bf16 tensor-core product with float32 accumulation computes.
"""

from __future__ import annotations

import torch

__all__ = ["PRECISIONS", "check_precision", "split_bf16", "dot3",
           "split_and_dot", "sqrt_rn"]

PRECISIONS = ("highest", "bf16x3")


def check_precision(precision):
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, "
                         f"got {precision!r}")
    return precision


def split_bf16(a):
    """Split float32 ``a`` into (hi, lo), each a bfloat16 value held in
    float32; both roundings are to nearest even, as ``astype`` does."""
    hi = a.to(torch.bfloat16).float()
    lo = (a - hi).to(torch.bfloat16).float()
    return hi, lo


def dot3(a, b):
    """The 3-pass product of split operands ``a = (hi, lo)``, ``b = (hi,
    lo)``, summed as ``origin_tpu.ops.pallas_prec.make_dot`` sums it."""
    return a[0] @ b[0] + a[0] @ b[1] + a[1] @ b[0]



def split_and_dot(precision):
    """``(split, dot)`` of a precision: ``dot(split(a), split(b))`` is
    ``a @ b`` in it (the identity and ``torch.matmul`` at ``highest``)."""
    if check_precision(precision) == "bf16x3":
        return split_bf16, dot3
    return (lambda a: a), torch.matmul


def sqrt_rn(x):
    """Correctly rounded square root of a float32 tensor.

    torch's float32 ``sqrt`` on the CPU is not correctly rounded (about
    0.2% of a cube's values differ from numpy's in the last bit), and
    its bits vary from one process to the next: step 01's ``cube_std``
    came out another way in 2 of 18 runs of the minicube, which moved a
    detection across the threshold.  A float64 square root rounded to
    float32 is the correctly rounded one, which CUDA's float32 ``sqrt``
    already gives, so the CPU then computes the card's bits.
    """
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).to(x.dtype)
    return torch.sqrt(x)
