"""Step 08's line estimation: origin_tpu_torch.ops.lines against the JAX
package's origin_tpu.ops.lines on the same numpy inputs from a seed.

The JAX side runs its power iterations to the whole 200-step budget
(tests/jax_full_budget.py), as the port does.  Tolerances:

- ``ls_deconv_wgt``: rtol 1e-5 against the JAX function; against the
  float64 oracle at the JAX test's own rtol 2e-4 / atol 1e-5.
- ``method_pca_wgt`` on minicubes with a line: rtol 1e-4 against the JAX
  function, and against the ARPACK oracle at the JAX test's own atol /
  rtol 0.05 (estimate) and rtol 1e-3 (variance).
- ``grid_analysis_batch`` and ``estimation_line_arrays``: ``y``, ``x``,
  ``z`` and ``ok`` exactly; ``flux``, ``residual``, ``line`` and
  ``line_var`` at rtol 1e-4, the per-channel arrays with an atol of 1e-4
  times the array's largest magnitude, since a line passes through zero.
- The largest reading of all these comparisons is 1.4e-6 (the smallest
  rtol each would pass, measured on the CPU with 2 torch threads).
- The minicube gather is bit for bit the JAX engine's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import oracle
from jax_full_budget import jax_full_budget
from lines_cases import (
    KEYS,
    chunk_case,
    field,
    grid_inputs,
    hold,
    line_minicube,
    small_field,
)
from origin_tpu.ops import lines as jlines
from origin_tpu.pipeline.engine import (
    _gather_minicubes,
    _gather_minicubes_padded,
)
from origin_tpu_torch.ops import lines
from origin_tpu_torch.ops.dct import dctmat

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- ls_deconv_wgt ------------------------------------------------------------
def test_ls_deconv_matches_jax_and_oracle():
    rng = np.random.default_rng(41)
    nl, s = 30, 5
    data = rng.normal(size=(nl, s, s))
    var = rng.uniform(0.5, 2, size=(nl, s, s))
    psf = rng.uniform(0, 1, size=(nl, s, s))
    f32 = [a.astype(np.float32) for a in (data, var, psf)]
    d, v = lines.ls_deconv_wgt(*map(_t, f32))
    jd, jv = jlines.ls_deconv_wgt(*map(jnp.asarray, f32))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-5)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=1e-5)
    ed, ev = oracle.ls_deconv_oracle(data, var, psf)
    np.testing.assert_allclose(d.numpy(), ed, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(v.numpy(), ev, rtol=2e-4)


# -- method_pca_wgt -----------------------------------------------------------
@pytest.mark.parametrize("order_dct", [30, None])
def test_method_pca_wgt_matches_jax_full_budget(order_dct):
    cubes = [line_minicube(seed=seed, z0=z0)
             for seed, z0 in ((43, 30), (7, 12), (8, 47))]
    data = np.stack([c[0] for c in cubes])
    var = np.stack([c[1] for c in cubes])
    psf = cubes[0][2]
    d0 = None if order_dct is None else dctmat(60, order_dct)
    est, estvar = lines.method_pca_wgt(
        _t(data), _t(var), _t(psf), None if d0 is None else _t(d0))
    with jax_full_budget():
        for i in range(len(cubes)):
            je, jv = jlines.method_pca_wgt(
                jnp.asarray(data[i]), jnp.asarray(var[i]), jnp.asarray(psf),
                None if d0 is None else jnp.asarray(d0))
            np.testing.assert_allclose(est[i].numpy(), np.asarray(je),
                                       rtol=1e-4,
                                       atol=1e-4 * float(jnp.abs(je).max()))
            np.testing.assert_allclose(estvar[i].numpy(), np.asarray(jv),
                                       rtol=1e-4)


def test_method_pca_wgt_matches_oracle():
    data, var, psf, _ = line_minicube()
    est, estvar = lines.method_pca_wgt(_t(data[None]), _t(var[None]),
                                       _t(psf), _t(dctmat(60, 30)))
    eest, eestvar = oracle.method_pca_wgt_oracle(data, var, psf, 30)
    np.testing.assert_allclose(est[0].numpy(), eest, atol=0.05, rtol=0.05)
    np.testing.assert_allclose(estvar[0].numpy(), eestvar, rtol=1e-3)
    assert abs(int(torch.argmax(est[0])) - 30) <= 1


# -- the minicube gather --------------------------------------------------------
@pytest.mark.parametrize("sg", [5, 9, 25])
def test_engine_gather_equals_jax_bit_for_bit(sg, tmp_path):
    """sg 5 and 9 take the JAX engine's clipped gather on this 10 x 12
    field, sg 25 (a window larger than the field) its padded gather; the
    port's one gather gives both, NaN voxels filled as the session fills
    them."""
    from origin_tpu_torch.core import Cube
    from origin_tpu_torch.pipeline.session import ORIGIN
    from tools_torch.synthetic import make_minicube

    path = str(tmp_path / "tiny.fits")
    make_minicube(path, nz=40, ny=10, nx=12)
    cube = Cube(path)
    cube.data[3, 0, 0] = cube.data[7, 4:6, 9] = np.nan
    cube.mask = ~np.isfinite(cube.data)
    orig = ORIGIN.init(cube, device="cpu", path=str(tmp_path), name="g",
                       loglevel="WARNING")
    ys = np.array([0, 9, 5, 4, 2, 8])
    xs = np.array([0, 11, 6, 10, 1, 3])
    dat, var = (w.numpy() for w in orig.engine.minicubes(xs, ys, sg))
    jc, jv = jnp.asarray(orig.cube_raw), jnp.asarray(orig.var)
    jy, jx = jnp.asarray(ys, jnp.int32), jnp.asarray(xs, jnp.int32)
    if sg <= 10:
        ref = _gather_minicubes(jc, jv, jy, jx, sg)
    else:
        h = sg // 2
        pad = ((0, 0), (h, h), (h, h))
        ref = _gather_minicubes_padded(
            jnp.pad(jc, pad), jnp.pad(jv, pad, constant_values=np.inf),
            jy, jx, sg)
    for got, want in zip((dat, var), ref):
        assert got.shape == (len(ys), 40, sg, sg)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      np.asarray(want).view(np.uint32))
    orig.close_logfile()


def test_gather_windows_fills_weights_outside_the_field():
    wmaps = _t(np.arange(2 * 4 * 5, dtype=np.float32).reshape(2, 4, 5) + 1)
    win = lines.gather_windows(wmaps, torch.tensor([0, 3]),
                               torch.tensor([4, 2]), 3, 0.0).numpy()
    assert win.shape == (2, 2, 3, 3)
    want = np.zeros((2, 3, 3), np.float32)
    want[:, 1:, :2] = wmaps.numpy()[:, 0:2, 3:5]
    np.testing.assert_array_equal(win[0], want)


# -- grid_analysis_batch --------------------------------------------------------
def _run_grid(fld, mosaic, g, criteria):
    args = grid_inputs(fld, mosaic, g, "cpu")
    nl, ny, nx = fld[0].shape
    got = lines.grid_analysis_batch(*args, ny, nx, size_grid=g,
                                    criteria=criteria)
    dat, var, zs, ys, xs, psf, wgt, d0 = (
        None if a is None else jnp.asarray(a.numpy()) for a in args)
    with jax_full_budget():
        want = jlines.grid_analysis_batch(
            dat, var, zs.astype(jnp.int32), ys.astype(jnp.int32),
            xs.astype(jnp.int32), psf,
            wgt if mosaic else jnp.zeros((len(xs),)), d0, ny, nx,
            size_grid=g, criteria=criteria, has_weights=mosaic)
    return ({k: v.numpy() for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


@pytest.mark.parametrize("criteria", ["flux", "mse"])
@pytest.mark.parametrize("mosaic", [False, True], ids=["field", "mosaic"])
@pytest.mark.parametrize("g", [0, 1])
def test_grid_analysis_matches_jax(g, mosaic, criteria):
    got, want = _run_grid(field(), mosaic, g, criteria)
    hold(got, want, rtol=1e-4)
    assert got["ok"][0] and got["y"][0] == 10 and got["x"][0] == 10
    assert got["z"][2] < 5 or not got["ok"][2]


@pytest.mark.parametrize("g", [0, 1])
def test_grid_analysis_window_larger_than_the_field(g):
    """A 7 x 7 field under a 9 x 9 window (11 x 11 with the grid): most
    of each minicube lies outside the field."""
    got, want = _run_grid(small_field(), False, g, "flux")
    hold(got, want, rtol=1e-4)


# -- estimation_line_arrays ---------------------------------------------------
def _estimate_both(x, y, z, raw, var, psf, **kw):
    got = lines.estimation_line_arrays(x, y, z, raw, var, psf, device="cpu",
                                       **kw)
    with jax_full_budget():
        want = jlines.estimation_line_arrays(x, y, z, raw, var, psf, **kw)
    assert set(got) == set(want) == set(KEYS)
    return got, want


def test_estimation_line_end_to_end():
    """Mirror of the JAX package's test, and the JAX function's values."""
    raw, var, psf, line = field()
    out, want = _estimate_both(np.array([10]), np.array([10]),
                               np.array([30]), raw, var, psf, size_grid=0)
    hold(out, want, rtol=1e-4)
    assert out["ok"][0]
    assert abs(int(out["z"][0]) - 30) <= 1
    assert out["flux"][0] > 0
    expected = line[25:36].sum()
    assert abs(out["flux"][0] - expected) / expected < 0.25


def test_estimation_line_grid_refines_position():
    raw, var, psf, _ = field(seed=45)
    out, want = _estimate_both(np.array([11]), np.array([9]),
                               np.array([30]), raw, var, psf, size_grid=1)
    hold(out, want, rtol=1e-4)
    assert out["ok"][0]
    assert int(out["y"][0]) == 10 and int(out["x"][0]) == 10


@pytest.mark.parametrize("mosaic", [False, True], ids=["field", "mosaic"])
def test_estimation_line_chunks_match_jax(mosaic):
    """Five detections in chunks of two (a partial last chunk), on a field
    or on two weighted fields (the JAX package cuts those windows on the
    host)."""
    *args, kw = chunk_case(mosaic)
    out, want = _estimate_both(*args, **kw)
    hold(out, want, rtol=1e-4)


def test_estimation_line_no_detections():
    raw, var, psf, _ = field()
    out = lines.estimation_line_arrays(np.array([], int), np.array([], int),
                                       np.array([], int), raw, var, psf,
                                       device="cpu")
    assert all(len(out[k]) == 0 for k in KEYS)
