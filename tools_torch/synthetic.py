"""Synthetic MUSE-like cubes for the port, built on its own ``core``.

Copies of ``tests/make_minicube.py`` (the JAX package's golden minicube
and its segmentation map) and of ``tools/bench_e2e.make_field`` (the
3681 x 100 x 200 field), with ``origin_tpu_torch.core`` in place of
``origin_tpu.core``: the same seeds give the same data, variance and
header bit for bit (``tests/test_torch_import.py`` holds them to the
originals).
"""

import numpy as np

from origin_tpu_torch.core import Cube, Image, MoffatFSF, WCS, WaveCoord

# injected faint emission lines: (x, y, z, amplitude, line_sigma_channels)
FAINT_LINES = [
    (15, 12, 80, 2.2, 1.2),
    (45, 20, 200, 2.5, 2.8),
    (30, 45, 320, 2.0, 1.0),
    (52, 52, 140, 2.8, 5.0),
    (12, 40, 260, 2.4, 1.5),
]

# bright lines sitting on continuum objects (detectable pre-PCA)
BRIGHT_LINES = [
    (20, 25, 120, 25.0, 1.5),
    (42, 38, 300, 20.0, 2.0),
]

# continuum objects: (x, y, amplitude, spatial_sigma)
CONTINUUM = [
    (20, 25, 8.0, 2.0),
    (42, 38, 6.0, 2.5),
]


def make_minicube(path=None, nz=500, ny=60, nx=60, seed=1234, noise=1.0):
    """Build the synthetic minicube; optionally write it to ``path``."""
    rng = np.random.default_rng(seed)
    wave = WaveCoord(crpix=1.0, crval=4750.0, cdelt=1.25, shape=nz)
    wcs = WCS(crpix=(ny / 2, nx / 2), crval=(-30.0, 53.0), shape=(ny, nx))
    fsf = MoffatFSF(fwhm_pol=[-0.2, 0.7], beta_pol=[2.8], pixstep=0.2)

    lbda = wave.coord()
    sigma_z = noise * (1.0 + 0.2 * np.sin(np.arange(nz) / 60.0))
    data = rng.normal(size=(nz, ny, nx)) * sigma_z[:, None, None]
    var = np.broadcast_to((sigma_z ** 2)[:, None, None], (nz, ny, nx)).copy()

    yy, xx = np.mgrid[:ny, :nx]
    zz = np.arange(nz)

    # continuum galaxies: smooth spectrum x extended spatial profile
    for (x0, y0, amp, sig) in CONTINUUM:
        spatial = np.exp(-0.5 * ((yy - y0) ** 2 + (xx - x0) ** 2) / sig ** 2)
        spectrum = amp * (1.0 + 0.3 * np.cos(2 * np.pi * zz / nz)
                          + 0.2 * zz / nz)
        data += spectrum[:, None, None] * spatial[None]

    # emission-line point sources convolved with the FSF; lines landing
    # outside a (small) field are skipped, injection windows are clipped
    half = 7
    for (x0, y0, z0, amp, lsig) in FAINT_LINES + BRIGHT_LINES:
        if not (0 <= x0 < nx and 0 <= y0 < ny and 0 <= z0 < nz):
            continue
        line = amp * np.exp(-0.5 * ((zz - z0) / lsig) ** 2)
        zs = slice(max(0, z0 - 40), min(nz, z0 + 41))
        spot = fsf.get_3darray(lbda[zs], (2 * half + 1, 2 * half + 1))
        spot = spot / spot.max(axis=(1, 2), keepdims=True)
        ys0, ys1 = max(0, y0 - half), min(ny, y0 + half + 1)
        xs0, xs1 = max(0, x0 - half), min(nx, x0 + half + 1)
        data[zs, ys0:ys1, xs0:xs1] += (
            line[zs, None, None]
            * spot[:, ys0 - (y0 - half) : ys1 - (y0 - half),
                   xs0 - (x0 - half) : xs1 - (x0 - half)]
        )

    # masked voxels: a corner column and a few random voxels
    data[:, 0, 0] = np.nan
    var[:, 0, 0] = np.nan
    bad = rng.integers(0, nz * ny * nx, size=50)
    data.ravel()[bad] = np.nan

    cube = Cube(data=data.astype(np.float32), var=var.astype(np.float32),
                wcs=wcs, wave=wave)
    fsf.to_header(cube.primary_header)
    cube.primary_header["CUBE_V"] = "synthetic-1.0"
    if path is not None:
        cube.write(path)
    return cube


def make_segmap(path=None, ny=60, nx=60):
    """Segmentation map marking the continuum objects (label 1, 2)."""
    segmap = np.zeros((ny, nx), dtype=np.int64)
    for lab, (x0, y0, amp, sig) in enumerate(CONTINUUM, start=1):
        yy, xx = np.mgrid[:ny, :nx]
        segmap[((yy - y0) ** 2 + (xx - x0) ** 2) <= (3 * sig) ** 2] = lab
    if path is not None:
        Image(data=segmap).write(path)
    return segmap


def make_field(nz=3681, ny=100, nx=200, seed=7, noise=1.0,
               n_cont=12, n_faint=40, n_bright=8):
    """Synthetic MUSE-like field with randomly placed sources.

    Returns ``(cube, lines)``, ``lines`` the injected (x, y, z, kind)
    with kind ``"faint"`` or ``"bright"``.
    """
    rng = np.random.default_rng(seed)
    wave = WaveCoord(crpix=1.0, crval=4750.0, cdelt=1.25, shape=nz)
    wcs = WCS(crpix=(ny / 2, nx / 2), crval=(-30.0, 53.0), shape=(ny, nx))
    fsf = MoffatFSF(fwhm_pol=[-0.2, 0.7], beta_pol=[2.8], pixstep=0.2)
    lbda = wave.coord()

    sigma_z = noise * (1.0 + 0.2 * np.sin(np.arange(nz) / 60.0))
    data = rng.normal(size=(nz, ny, nx)).astype(np.float32)
    data *= sigma_z[:, None, None].astype(np.float32)
    var = np.broadcast_to(
        (sigma_z ** 2)[:, None, None].astype(np.float32), (nz, ny, nx)
    ).copy()

    yy, xx = np.mgrid[:ny, :nx]
    zz = np.arange(nz)

    margin = 10

    def rand_pos(n):
        return np.stack([
            rng.integers(margin, nx - margin, n),
            rng.integers(margin, ny - margin, n),
        ], axis=1)

    # continuum galaxies
    for (x0, y0) in rand_pos(n_cont):
        amp = rng.uniform(3.0, 9.0)
        sig = rng.uniform(1.5, 3.0)
        spatial = np.exp(-0.5 * ((yy - y0) ** 2 + (xx - x0) ** 2) / sig ** 2)
        spectrum = amp * (1.0 + 0.3 * np.cos(2 * np.pi * zz / nz)
                          + 0.2 * zz / nz)
        data += (spectrum[:, None, None] * spatial[None]).astype(np.float32)

    # emission lines (FSF-convolved point sources)
    half = 7
    lines = []
    for kind, n, amps in (("faint", n_faint, (2.0, 3.2)),
                          ("bright", n_bright, (15.0, 30.0))):
        for (x0, y0) in rand_pos(n):
            z0 = int(rng.integers(60, nz - 60))
            amp = rng.uniform(*amps)
            lsig = rng.uniform(1.0, 4.0)
            line = amp * np.exp(-0.5 * ((zz - z0) / lsig) ** 2)
            zs = slice(max(0, z0 - 40), min(nz, z0 + 41))
            spot = fsf.get_3darray(lbda[zs], (2 * half + 1, 2 * half + 1))
            spot = spot / spot.max(axis=(1, 2), keepdims=True)
            data[zs, y0 - half : y0 + half + 1, x0 - half : x0 + half + 1] += (
                line[zs, None, None] * spot
            ).astype(np.float32)
            lines.append((int(x0), int(y0), z0, kind))

    data[:, 0, 0] = np.nan
    var[:, 0, 0] = np.nan

    cube = Cube(data=data, var=var, wcs=wcs, wave=wave)
    fsf.to_header(cube.primary_header)
    cube.primary_header["CUBE_V"] = "synthetic-e2e-1.0"
    return cube, lines
