"""DCT continuum estimation (torch port of :mod:`origin_tpu.ops.dct`).

The variance-weighted GLS continuum

    C_s = D (D^T Sigma_s^-1 D)^-1 D^T Sigma_s^-1 S_s

is evaluated for all spaxels at once: the (order+1)^2 normal matrices come
from one matmul over the spectral axis, then one batched Cholesky solve.
Spaxels with any masked channel use unit weights, which is exactly the
unweighted projection because the DCT basis is orthonormal.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["dctmat", "dct_residual"]


def dctmat(nl, order, dtype=np.float32):
    """Orthonormal DCT-II basis matrix of shape (nl, order+1)."""
    yy, xx = np.mgrid[:nl, : order + 1]
    d0 = np.sqrt(2.0 / nl) * np.cos((yy + 0.5) * (np.pi / nl) * xx)
    d0[:, 0] /= np.sqrt(2.0)
    return d0.astype(dtype)


def dct_residual(w_raw, order, var=None, approx=False, mask=None,
                 with_coef=False):
    """Continuum cube estimated by a low-order DCT fit.

    ``w_raw`` is the (Nz, Ny, Nx) zero-filled cube, ``var`` the per-voxel
    variance (None or ``approx`` for the unweighted projection) and
    ``mask`` the invalid voxels.  Returns the (Nz, Ny, Nx) continuum; with
    ``with_coef``, also the (order+1, Ny, Nx) basis coefficients.
    """
    nl = w_raw.shape[0]
    d0 = torch.as_tensor(dctmat(nl, order), dtype=w_raw.dtype,
                         device=w_raw.device)

    if approx or var is None:
        coef = torch.einsum("zi,zyx->iyx", d0, w_raw)
        cont = torch.einsum("zi,iyx->zyx", d0, coef)
        return (cont, coef) if with_coef else cont

    ivar = 1.0 / var
    if mask is not None:
        valid = ~torch.any(mask, dim=0)
        ivar = torch.where(valid[None], ivar, 1.0)
    ivar = torch.where(torch.isfinite(ivar), ivar, 0.0)

    # normal matrices A_s = D^T diag(ivar_s) D for every spaxel, as one
    # matmul over z: A[s, i*k+j] = sum_z ivar[z, s] * D[z, i] * D[z, j]
    nz, ny, nx = w_raw.shape
    k = order + 1
    dd = (d0[:, :, None] * d0[:, None, :]).reshape(nz, k * k)
    a = (ivar.reshape(nz, -1).T @ dd).reshape(ny * nx, k, k)
    b = (w_raw * ivar).reshape(nz, -1).T @ d0  # (S, k)
    # cholesky_ex: no host sync for the error flag; a failed factorization
    # yields non-finite coefficients, as the JAX Cholesky does
    chol, _ = torch.linalg.cholesky_ex(a)
    coef = torch.cholesky_solve(b[..., None], chol)[..., 0]  # (S, k)
    cont = (d0 @ coef.T).reshape(nz, ny, nx)
    if with_coef:
        return cont, coef.T.reshape(k, ny, nx)
    return cont
