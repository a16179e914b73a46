"""Inputs and checks shared by the line-estimation tests of the torch port
(tests/test_torch_lines.py against the JAX package on the CPU,
tests/test_torch_gpu.py on the card against the CPU).  numpy and the
port only: the GPU tests import no JAX."""

import numpy as np
import torch

from origin_tpu_torch.core import MoffatFSF
from origin_tpu_torch.ops import lines

KEYS = ("flux", "residual", "line", "line_var", "y", "x", "z", "ok")


def psf_cube(nl, s, scale=1.0):
    fsf = MoffatFSF(fwhm_pol=[0.5 * scale], beta_pol=[2.8], pixstep=0.2)
    return fsf.get_3darray(np.linspace(5000, 6000, nl),
                           (s, s)).astype(np.float32)


def line_minicube(nl=60, s=9, seed=43, amp=8.0, z0=30):
    """The JAX package's test minicube (tests/test_ops.py): a Gaussian
    line of the PSF's shape in white noise of variance 0.09."""
    rng = np.random.default_rng(seed)
    psf = psf_cube(nl, s)
    line = amp * np.exp(-0.5 * ((np.arange(nl) - z0) / 2.0) ** 2)
    data = rng.normal(scale=0.3, size=(nl, s, s)) + line[:, None, None] * psf
    var = np.full((nl, s, s), 0.09)
    return data.astype(np.float32), var.astype(np.float32), psf, line


def field(nl=60, ny=21, nx=21, seed=44, s=9):
    """The JAX package's 21 x 21 test field: noise with the line minicube
    at (10, 10), variance 0.09."""
    data, _, psf, line = line_minicube(nl=nl, s=s)
    rng = np.random.default_rng(seed)
    raw = rng.normal(scale=0.3, size=(nl, ny, nx)).astype(np.float32)
    raw[:, 6:15, 6:15] = data
    return raw, np.full((nl, ny, nx), 0.09, np.float32), psf, line


def small_field(seed=9):
    """A 7 x 7 field cut from a line minicube: a 9 x 9 window (11 x 11
    with the grid) lies mostly outside it."""
    data, var, psf, line = line_minicube(seed=seed)
    return (np.ascontiguousarray(data[:, 1:8, 1:8]),
            np.ascontiguousarray(var[:, :7, :7]), psf, line)


def grid_inputs(fld, mosaic, g, device, s=9):
    """Tensors on ``device`` for ``grid_analysis_batch``: the minicubes of
    four detections of ``fld``, z0s, y0s, x0s, the PSF (two fields scaled
    apart when ``mosaic``), the weight windows (None for one field) and
    the DCT basis.

    The detections: the line at the centre ((10, 10) on the 21 x 21
    field), a neighbour one channel off, one at the field's corner with
    z0 < 5 (offsets out of the field, the clamped spectral window) and one
    at the far edge near the red end."""
    from origin_tpu_torch.ops.dct import dctmat

    raw, var, psf, _ = fld
    nl, ny, nx = raw.shape
    xs = np.array([nx // 2, nx // 2 + 1, 0, min(20, nx - 1)])
    ys = np.array([ny // 2, ny // 2 - 1, 0, min(16, ny - 1)])
    zs = np.array([30, 31, 3, nl - 3])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    ys_t, xs_t = t(ys), t(xs)
    sg = s + 2 * g
    wgt = None
    if mosaic:
        rng = np.random.default_rng(5)
        psf = np.stack([psf, psf_cube(nl, s, 1.3)])
        wmaps = rng.uniform(0.2, 1.0, size=(2, ny, nx)).astype(np.float32)
        wgt = lines.gather_windows(t(wmaps), ys_t, xs_t, sg, 0.0)
    return (lines.gather_windows(t(raw), ys_t, xs_t, sg, 0.0),
            lines.gather_windows(t(var), ys_t, xs_t, sg, np.inf),
            t(zs), ys_t, xs_t, t(psf), wgt, t(dctmat(nl, 30)))


def chunk_case(mosaic):
    """Five detections of the test field for ``estimation_line_arrays``
    in chunks of two (a partial last chunk), on one field or two weighted
    fields: (x, y, z, raw, var, psf, keywords)."""
    raw, var, psf, _ = field(seed=46)
    kw = dict(size_grid=1, batch=2)
    if mosaic:
        rng = np.random.default_rng(6)
        psf = [psf, psf_cube(60, 9, 1.3)]
        kw["weights"] = list(rng.uniform(0.2, 1.0, size=(2, 21, 21))
                             .astype(np.float32))
    return (np.array([10, 11, 0, 20, 3]), np.array([10, 9, 0, 20, 17]),
            np.array([30, 30, 3, 57, 40]), raw, var, psf, kw)


def hold(got, want, rtol):
    """Per-detection outputs: positions and ok exactly, values at rtol,
    the per-channel arrays with an atol of rtol times their largest
    magnitude (a line passes through zero)."""
    for key in ("y", "x", "z", "ok"):
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)
    for key in ("flux", "residual", "line", "line_var"):
        a, b = np.asarray(got[key], float), np.asarray(want[key], float)
        atol = rtol * np.abs(b[np.isfinite(b)]).max() if b.ndim > 1 else 0.0
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol, err_msg=key)
