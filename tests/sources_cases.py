"""Inputs of the step 10-11 window ops, shared by the CPU tests (the port
against the JAX package, tests/test_torch_sources.py) and the GPU tests
(the card against the CPU, tests/test_torch_gpu.py).  Made from
``numpy.random.default_rng(seed)``; imports nothing of JAX.

The field is (NZ, NY, NX); the windows of each edge size start outside
the field, straddle each of its four edges and corners, and lie inside
it, so every gather meets its fills.
"""

import numpy as np

NZ, NY, NX = 30, 12, 15
SIZES = (5, 7)


def window_starts(size):
    """(y0, x0) of the windows of edge ``size``: all pairs of starts that
    lie fully outside, cross the low edge, sit inside and cross the high
    edge of each axis."""
    def starts(n):
        return [-(size + 1), -(size - 1), -2, 0, n // 2 - size // 2,
                n - size, n - 2, n + 1]

    y0, x0 = np.meshgrid(starts(NY), starts(NX), indexing="ij")
    return y0.ravel(), x0.ravel()


def detection_cube(seed=0):
    """A positive (NZ, NY, NX) float32 statistic with a few NaN voxels
    (positive, so that a mean over a window has no cancellation and its
    float32 sums hold at rtol 1e-6)."""
    rng = np.random.default_rng(seed)
    cube = rng.uniform(0.5, 2.0, (NZ, NY, NX)).astype(np.float32)
    cube[rng.integers(0, NZ, 4), rng.integers(0, NY, 4),
         rng.integers(0, NX, 4)] = np.nan
    return cube


def line_jobs(size, seed=1):
    """(y0, x0, zlo, zhi) of one line job per window: slabs of one
    channel, at both spectral ends, and random ones."""
    rng = np.random.default_rng(seed)
    y0, x0 = window_starts(size)
    n = len(y0)
    zlo = rng.integers(0, NZ, n)
    zhi = np.minimum(NZ - 1, zlo + rng.integers(0, 9, n))
    zlo[:3], zhi[:3] = (0, NZ - 1, 7), (4, NZ - 1, 7)
    return y0, x0, zlo, zhi


def object_masks(size, n, seed=2):
    """(n, size, size) float32 0/1 masks; the first is empty."""
    rng = np.random.default_rng(seed)
    objm = (rng.random((n, size, size)) < 0.5).astype(np.float32)
    objm[0] = 0
    return objm


def spectra_inputs(size, seed=3):
    """The session's resident inputs and the step-11 jobs of one size.

    ``cube`` is zero-filled and ``var`` inf-filled where ``mask`` is True
    (the engine's convention); ``var`` is also 0 and inf at some unmasked
    voxels; one spaxel is masked at every channel, so a window over it has
    ``cnt == 0`` there.  Jobs: one per window, the second with an empty
    sky mask, each object mask covering the masked spaxel where its window
    does; one or two line weight images per source.
    """
    rng = np.random.default_rng(seed)
    raw = rng.normal(1.0, 1.0, (NZ, NY, NX)).astype(np.float32)
    mask = rng.random((NZ, NY, NX)) < 0.03
    mask[:, 5, 6] = True
    var = rng.uniform(0.5, 2.0, (NZ, NY, NX)).astype(np.float32)
    free = np.flatnonzero(~mask.ravel())
    var.ravel()[free[::37]] = 0.0
    var.ravel()[free[5::41]] = np.inf
    cube = np.where(mask, 0.0, raw).astype(np.float32)
    var = np.where(mask, np.inf, var).astype(np.float32)
    y0, x0 = window_starts(size)
    n = len(y0)
    objm = (rng.random((n, size, size)) < 0.6).astype(np.float32)
    skym = ((rng.random((n, size, size)) < 0.5) & (objm == 0)).astype(
        np.float32)
    skym[1] = 0
    for i in range(n):
        yy, xx = 5 - y0[i], 6 - x0[i]
        if 0 <= yy < size and 0 <= xx < size:
            objm[i, yy, xx] = 1
    nlines = rng.integers(1, 3, n)
    lsrc = np.repeat(np.arange(n), nlines)
    lw = rng.uniform(-0.2, 1.0, (len(lsrc), size, size)).astype(np.float32)
    wcube = rng.uniform(0.1, 1.0, (NZ, size, size)).astype(np.float32)
    return dict(cube=cube, var=var, mask=mask, y0=y0, x0=x0, objm=objm,
                skym=skym, lsrc=lsrc, lw=lw, wcube=wcube)


def spectra_jobs(case):
    """The job dicts of ``batched_source_spectra`` for a spectra case."""
    lines = {}
    for k, i in enumerate(case["lsrc"]):
        lines.setdefault(int(i), []).append((10 * int(i) + k, case["lw"][k]))
    return [dict(key=100 + i, y0=int(case["y0"][i]), x0=int(case["x0"][i]),
                 objm=case["objm"][i] > 0, skym=case["skym"][i] > 0,
                 lines=lines[i])
            for i in range(len(case["y0"]))]


def same_nonfinite(a, b):
    """NaN, +inf and -inf in the same places."""
    a, b = np.asarray(a), np.asarray(b)
    for test in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(test(a), test(b))


def hold_rows(got, want, rel):
    """``got`` within ``rel`` of each row's largest finite magnitude of
    ``want``, with NaN and infinities in the same places."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    same_nonfinite(got, want)
    fin = np.isfinite(want)
    scale = np.where(fin, np.abs(want), 0).reshape(len(want), -1).max(1)
    scale = np.where(scale > 0, scale, 1.0).reshape(
        (-1,) + (1,) * (want.ndim - 1))
    err = np.where(fin, np.abs(got - want) / scale, 0)
    assert err.max() <= rel, err.max()
