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

from .. import tracing
from ..device import resolve_device
from .stats import compute_thresh_gaussfit

__all__ = [
    "rank1_left_vector",
    "rank1_left_vectors",
    "greedy_pca",
    "greedy_pca_areas",
    "greedy_pca_by_area",
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
    pypx = (test > thres) & valid
    npyp = int(pypx.sum())  # the one host sync of a greedy iteration
    while npyp:
        nbiter += 1
        mapo2 += pypx.to(torch.int32)
        tracing.count("greedy.iterations")
        tracing.count("greedy.nuisance_columns", npyp)
        tracing.count("greedy.area_columns", npix)
        if nbiter > itermax:
            nstop += 1
            break
        if npyp == 1:  # the reference bails out before the SVD here
            break

        with tracing.span("greedy.iteration"):
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

            # nuisance block, orthogonalized against the background
            # signature
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
            pypx = (test > thres) & valid
            npyp = int(pypx.sum())
    if record_factors:
        return faint, mapo2, nstop, u_mat, c_mat
    return faint, mapo2, nstop


def greedy_pca_areas(flat, areamap, thresholds, testO2,
                     noise_population=50.0, itermax=100,
                     record_factors=False):
    """Greedy PCA of every area, in place on ``flat``.

    ``flat`` is the (Nz, Ny*Nx) tensor of the spectra, ``areamap`` a host
    (Ny, Nx) map of labels 1..N (0 outside every area), ``thresholds`` and
    ``testO2`` the per-area O2 thresholds and test vectors (one value per
    area spaxel, in the row-major order of ``areamap == a``).  Each area's
    columns are gathered on ``flat``'s device, cleaned by
    :func:`greedy_pca` and scattered back.  Returns ``(mapO2, nstop,
    factors)``: the host int32 (Ny, Nx) iteration counts, the number of
    areas that hit ``itermax``, and, with ``record_factors``, per area its
    flat spatial indices and the rank-1 factors ``(U, C)`` that the loop
    removed, trimmed to the used columns (else an empty list).
    """
    dev = flat.device
    areamap = np.asarray(areamap)
    mapO2 = np.zeros(areamap.shape, dtype=np.int32)
    nstop = 0
    factors = []
    for area in range(1, int(areamap.max()) + 1):
        (idx,) = np.nonzero((areamap == area).ravel())
        if idx.size == 0:
            continue
        with tracing.span("greedy.area", area=area, columns=int(idx.size)):
            didx = torch.from_numpy(idx.astype(np.int64)).to(dev)
            out = greedy_pca(
                flat[:, didx],
                torch.ones(idx.size, dtype=torch.bool, device=dev),
                torch.from_numpy(np.asarray(testO2[area - 1],
                                            np.float32)).to(dev),
                float(thresholds[area - 1]),
                noise_population=float(noise_population),
                itermax=int(itermax), record_factors=record_factors,
            )
            flat[:, didx] = out[0]
            mapO2.ravel()[idx] = out[1].cpu().numpy()
        nstop += int(out[2])
        if record_factors:
            u_mat, c_mat = (t.cpu().numpy() for t in out[3:])
            used = np.flatnonzero((u_mat != 0).any(axis=0))
            if used.size:
                factors.append((idx, u_mat[:, used],
                                np.ascontiguousarray(c_mat[used])))
    return mapO2, nstop, factors


def greedy_pca_by_area(cube_std, areamap, thresholds, testO2,
                       noise_population=50.0, itermax=100, device="cuda"):
    """Run the greedy PCA independently on every area (the reference's
    ``Compute_GreedyPCA_area``).

    ``cube_std`` is the host (Nz, Ny, Nx) cube, the other parameters as
    :func:`greedy_pca_areas`.  The areas run on ``device`` (``"cuda"``
    raises without a GPU; ``"cpu"`` when the caller asks for it).  Returns
    host ``(cube_faint, mapO2, nstop)``.
    """
    dev = resolve_device(device)
    cube_std = np.asarray(cube_std, dtype=np.float32)
    flat = torch.tensor(cube_std.reshape(cube_std.shape[0], -1), device=dev)
    mapO2, nstop, _ = greedy_pca_areas(
        flat, areamap, thresholds, testO2,
        noise_population=noise_population, itermax=itermax)
    return flat.reshape(cube_std.shape).cpu().numpy(), mapO2, nstop


def compute_pca_threshold(cube_area, pfa, device="cuda"):
    """O2 test + Gaussian-fit threshold for one area (host, numpy).

    Host work in both packages: the float64 mean over z of the squares of
    the (Nz, Np) ``cube_area``, in numpy's summation order, then the
    histogram fit.  ``device`` follows the rule of every entry that takes
    host arrays: ``"cuda"`` (the default) raises without a GPU, so a
    script written for the card fails here as its other calls do.
    Returns (test, hist, bins, thres, mea, std).
    """
    resolve_device(device)
    cube_area = np.asarray(cube_area, dtype=np.float64)
    test = np.mean(cube_area ** 2, axis=0)
    hist, bins, thres, mea, std = compute_thresh_gaussfit(test, pfa)
    return test, hist, bins, thres, mea, std
