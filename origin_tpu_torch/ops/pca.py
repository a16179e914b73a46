"""Greedy iterative PCA nuisance removal (torch port of
:mod:`origin_tpu.ops.pca`).

The JAX package runs the greedy loop as a ``lax.while_loop`` on device.
Here it is a Python loop that syncs with the host once per greedy
iteration (to test whether any spaxel still exceeds the O2 threshold), and
the 200-step power iteration inside it never syncs: it always runs its
whole budget (see :func:`rank1_left_vector` for why it has no stop test).

Selection ties follow the JAX semantics: ``argsort`` is stable (the JAX
default), ``argmax`` returns the first maximal column.
"""

from __future__ import annotations

import numpy as np
import torch

from .stats import compute_thresh_gaussfit

__all__ = [
    "rank1_left_vector",
    "rank1_left_vectors",
    "greedy_pca",
    "compute_pca_threshold",
]


def rank1_left_vector(m, iters=200):
    """Dominant left singular vector of m (nz, np) by ``iters`` power steps.

    :func:`origin_tpu.ops.pca.rank1_left_vector` also stops once
    ``1 - |<u', u>|`` falls to 1e-7.  In float32 that quantity is smaller
    than the rounding noise of the dot product that measures it (~1e-6 over
    a few thousand channels), so whether and where that loop stops depends
    on how the framework sums.  A stop at 1e-7, measured exactly, leaves
    ``u`` ~4e-4 rad short of convergence, enough to flip spaxels across the
    hard O2 threshold.  This port always runs the whole budget, which the
    JAX function also does when its noisy test never fires; both packages
    then give the same greedy-PCA result to float32 summation order.
    """
    eps = 1e-30
    colnorm = torch.sum(m * m, dim=0)
    u = m[:, torch.argmax(colnorm)]
    u = u / (torch.linalg.vector_norm(u) + eps)
    for _ in range(iters):
        u = m @ (m.T @ u)
        u = u / (torch.linalg.vector_norm(u) + eps)
    return u


def rank1_left_vectors(m, iters=200):
    """:func:`rank1_left_vector` of each (nz, np) matrix of a (B, nz, np)
    batch, as the JAX package's ``vmap`` of it computes them: the same
    start column (first of largest norm), the same ``+ 1e-30`` and the
    whole ``iters`` budget, with batched matrix products.  Returns (B, nz).
    """
    eps = 1e-30
    colnorm = torch.sum(m * m, dim=1)
    start = torch.argmax(colnorm, dim=1)
    u = torch.take_along_dim(m, start[:, None, None], dim=2)
    u = u / (torch.linalg.vector_norm(u, dim=1, keepdim=True) + eps)
    mt = m.transpose(1, 2)
    for _ in range(iters):
        u = torch.bmm(m, torch.bmm(mt, u))
        u = u / (torch.linalg.vector_norm(u, dim=1, keepdim=True) + eps)
    return u[:, :, 0]


def greedy_pca(cube, valid, test0, thres, noise_population=50.0, itermax=100,
               record_factors=False):
    """Greedy PCA on one area.

    Parameters and returns as :func:`origin_tpu.ops.pca.greedy_pca`:
    ``cube`` (Nz, Np) float32 spectra (columns where ``valid`` is False
    must be zero), ``test0`` (Np,) initial O2 values, ``thres`` the O2
    threshold.  Returns ``(faint, mapO2, nstop)`` with ``nstop`` a Python
    int; with ``record_factors``, also ``(U, C)`` such that
    ``faint == cube - U @ C`` up to float32 summation order.
    """
    nz, npix = cube.shape
    dev = cube.device
    faint = cube
    test = torch.where(valid, test0, 0.0)
    mapo2 = torch.zeros(npix, dtype=torch.int32, device=dev)
    nstop = 0
    if record_factors:
        u_mat = torch.zeros((nz, itermax), dtype=cube.dtype, device=dev)
        c_mat = torch.zeros((itermax, npix), dtype=cube.dtype, device=dev)
    arange = torch.arange(npix, dtype=torch.int32, device=dev)
    nbiter = 0
    while True:
        pypx = (test > thres) & valid
        npyp = int(pypx.sum())  # the one host sync of a greedy iteration
        if npyp == 0:
            break
        nbiter += 1
        mapo2 += pypx.to(torch.int32)
        if nbiter > itermax:
            nstop += 1
            break
        if npyp == 1:  # the reference bails out before the SVD here
            break

        # background signature: mean of the nb faintest passing spectra
        passing = valid & (test > 0) & (test <= thres)
        npass = passing.sum()
        nb = 1 + (npass / noise_population).to(torch.int32)
        key = torch.where(passing, test, float("inf"))
        order = torch.argsort(key, stable=True)
        ranks = torch.empty(npix, dtype=torch.int32, device=dev)
        ranks[order] = arange
        w = ((ranks < nb) & passing).to(faint.dtype)
        b = (faint @ w) / torch.clamp(torch.sum(w), min=1.0)

        # nuisance block, orthogonalized against the background signature
        xr = torch.where(pypx[None, :], faint, 0.0)
        xr = xr - torch.outer(b, b @ xr)
        xr = xr / torch.sum(b * b)

        u = rank1_left_vector(xr)
        del xr
        c = u @ faint
        faint = faint - torch.outer(u, c)
        test = torch.where(valid, torch.mean(faint * faint, dim=0), 0.0)
        if record_factors:
            u_mat[:, nbiter - 1] = u
            c_mat[nbiter - 1] = c
    if record_factors:
        return faint, mapo2, nstop, u_mat, c_mat
    return faint, mapo2, nstop


def compute_pca_threshold(cube_area, pfa):
    """O2 test + Gaussian-fit threshold for one area (host, numpy).

    Returns (test, hist, bins, thres, mea, std).
    """
    cube_area = np.asarray(cube_area, dtype=np.float64)
    test = np.mean(cube_area ** 2, axis=0)
    hist, bins, thres, mea, std = compute_thresh_gaussfit(test, pfa)
    return test, hist, bins, thres, mea, std
