"""Parity of the torch port's device ops with the JAX package.

The same numpy inputs, made from a seed, go through each JAX function and
its counterpart in ``origin_tpu_torch`` on the CPU.  Tolerances, with
their reason:

- float32 elementwise/reduction ops (standardize, o2test, the DCT GLS
  solve, the spatial FSF stage): atol 1e-5 on unit-scale data, the two
  frameworks sum in different orders;
- the local-max filter is a selection: equal positions and values;
- greedy PCA, against the JAX function with its power iteration run to
  its whole budget as the port runs it (tests/jax_full_budget.py): equal
  mapO2 and nstop, faint at atol 1e-4, plus the single-nuisance bail-out
  case of tests/test_pca_hard.py (exact);
- the purity count scans: equal thresholds grid and exactly equal counts.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from origin_tpu.ops import dct as jdct
from origin_tpu.ops import glr as jglr
from origin_tpu.ops import localmax as jlm
from origin_tpu.ops import pca as jpca
from origin_tpu.ops import purity as jpur
from origin_tpu.ops import stats as jstats
from origin_tpu_torch.ops import dct as tdct
from origin_tpu_torch.ops import glr as tglr
from origin_tpu_torch.ops import localmax as tlm
from origin_tpu_torch.ops import pca as tpca
from origin_tpu_torch.ops import purity as tpur
from origin_tpu_torch.ops import stats as tstats
from jax_full_budget import jax_full_budget
from test_pca_hard import _correlated_cube

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.array(a))


def _cube_problem(seed=3, nz=64, ny=6, nx=5):
    rng = np.random.default_rng(seed)
    z = np.linspace(0, 1, nz)[:, None, None]
    cube = (2.0 + np.cos(3 * z) + rng.normal(size=(nz, ny, nx))).astype(
        np.float32)
    var = rng.uniform(0.5, 2.0, size=(nz, ny, nx)).astype(np.float32)
    mask = np.zeros((nz, ny, nx), bool)
    mask[5:9, 1, 2] = True
    mask[:, 0, 0] = True
    var[mask] = np.inf
    cube[mask] = 0.0
    return cube, var, mask


@pytest.mark.parametrize("approx", [False, True])
def test_dct_residual_cont_and_coef(approx):
    cube, var, mask = _cube_problem()
    cj, kj = jdct.dct_residual(jnp.asarray(cube), 10, var=jnp.asarray(var),
                               approx=approx, mask=jnp.asarray(mask),
                               with_coef=True)
    ct, kt = tdct.dct_residual(_t(cube), 10, var=_t(var), approx=approx,
                               mask=_t(mask), with_coef=True)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0, atol=1e-5)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=0, atol=1e-5)
    assert kt.shape == (11, 6, 5)


def test_standardize_and_o2test():
    cube, var, mask = _cube_problem(seed=4)
    cont = jdct.dct_residual(jnp.asarray(cube), 10, var=jnp.asarray(var),
                             mask=jnp.asarray(mask))
    dj, sj, mj = jstats.standardize(jnp.asarray(cube), cont, jnp.asarray(var),
                                    jnp.asarray(mask), with_mean=True)
    dt, st, mt = tstats.standardize(_t(cube), _t(cont), _t(var), _t(mask),
                                    with_mean=True)
    for a, b in ((dt, dj), (st, sj), (mt, mj)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
    np.testing.assert_allclose(tstats.o2test(_t(dj)).numpy(),
                               np.asarray(jstats.o2test(dj)), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("size", [3, 5])
def test_compute_local_max_positions(size):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(30, 7, 9)).astype(np.float32)
    y = rng.normal(size=(30, 7, 9)).astype(np.float32)
    x[4, 3, 3] = x[4, 3, 4] = 9.0  # a plateau: ties keep the value
    mask = rng.random((30, 7, 9)) < 0.05
    jmax, jmin = jlm.compute_local_max(jnp.asarray(x), jnp.asarray(y),
                                       jnp.asarray(mask), size)
    tmax, tmin = tlm.compute_local_max(_t(x), _t(y), _t(mask), size)
    for a, b in ((tmax, jmax), (tmin, jmin)):
        np.testing.assert_array_equal(a.numpy() != 0, np.asarray(b) != 0)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _greedy_both(cube, test, thres, itermax=100):
    npix = cube.shape[1]
    with jax_full_budget():
        fj, mj, kj, uj, cj = jpca.greedy_pca(
            jnp.asarray(cube), jnp.ones(npix, bool), jnp.asarray(test),
            thres, itermax=itermax, record_factors=True)
    ft, mt, kt, ut, ct = tpca.greedy_pca(
        _t(cube), torch.ones(npix, dtype=torch.bool), _t(test), thres,
        itermax=itermax, record_factors=True)
    return ((np.asarray(fj), np.asarray(mj), int(kj), np.asarray(uj),
             np.asarray(cj)),
            (ft.numpy(), mt.numpy(), kt, ut.numpy(), ct.numpy()))


def test_greedy_pca_separated_nuisance():
    cube, _ = _correlated_cube(np.random.default_rng(1), n_cont=2,
                               n_bright=10)
    test = np.mean(cube.astype(np.float64) ** 2, axis=0).astype(np.float32)
    thres = float(np.percentile(test, 85.0))
    (fj, mj, kj, uj, cj), (ft, mt, kt, ut, ct) = _greedy_both(cube, test,
                                                             thres)
    np.testing.assert_array_equal(mt, mj)
    assert kt == kj == 0
    assert mj.max() >= 2  # the loop ran real iterations
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-4)
    # record_factors: faint == cube - U @ C
    np.testing.assert_allclose(cube - ut @ ct, ft, rtol=0, atol=1e-4)


def test_greedy_pca_single_nuisance_bailout():
    """tests/test_pca_hard.py's bail-out: one column above the threshold
    leaves the cube untouched but counts the iteration."""
    rng = np.random.default_rng(42)
    cube = rng.normal(size=(120, 64)).astype(np.float32)
    cube[:, 7] *= 30.0
    test = np.mean(cube.astype(np.float64) ** 2, axis=0).astype(np.float32)
    thres = float(np.sort(test)[-2] * 1.5)
    (fj, mj, kj, _, _), (ft, mt, kt, ut, _) = _greedy_both(cube, test, thres)
    np.testing.assert_array_equal(mt, mj)
    assert mt[7] == 1 and mt.sum() == 1
    assert kt == kj == 0
    np.testing.assert_array_equal(ft, cube)
    assert not ut.any()


def test_greedy_pca_itermax_stop():
    cube, _ = _correlated_cube(np.random.default_rng(2), nz=200, npix=256,
                               n_bright=30)
    test = np.mean(cube.astype(np.float64) ** 2, axis=0).astype(np.float32)
    thres = float(np.percentile(test, 5.0))
    (_, mj, kj, _, _), (_, mt, kt, _, _) = _greedy_both(cube, test, thres,
                                                       itermax=5)
    assert kt == kj == 1
    np.testing.assert_array_equal(mt, mj)
    assert mt.max() == 6  # the bail-out iteration still counts


def test_power_iteration_matches():
    rng = np.random.default_rng(7)
    u = rng.normal(size=80)
    m = (np.outer(u, rng.normal(size=50)) * 5
         + rng.normal(size=(80, 50)) * 0.1).astype(np.float32)
    uj = np.asarray(jpca.rank1_left_vector(jnp.asarray(m), tol=-1.0))
    ut = tpca.rank1_left_vector(_t(m)).numpy()
    np.testing.assert_allclose(np.abs(ut), np.abs(uj), rtol=0, atol=1e-5)


def test_precompute_spatial_and_matmul():
    from origin_tpu.core.fsf import MoffatFSF

    nz, ny, nx = 16, 14, 11
    fsf = MoffatFSF(fwhm_pol=[-0.2, 0.7], beta_pol=[2.8], pixstep=0.2)
    lbda = np.linspace(4800, 9000, nz)
    psfs = fsf.get_3darray(lbda, (9, 9)).astype(np.float32)[None]
    rng = np.random.default_rng(8)
    cube = rng.normal(size=(nz, ny, nx)).astype(np.float32)
    fshape2 = jglr.fft2_shape((ny, nx), (9, 9))
    for wmaps in (None, rng.uniform(0, 1, size=(2, ny, nx)).astype(
            np.float32)):
        p = psfs if wmaps is None else np.concatenate([psfs, psfs[:, ::-1]])
        kj, nj = jglr.precompute_spatial(
            jnp.asarray(p), None if wmaps is None else jnp.asarray(wmaps),
            ny, nx, fshape2)
        kt, nt = tglr.precompute_spatial(
            _t(p), None if wmaps is None else _t(wmaps), ny, nx, fshape2)
        np.testing.assert_allclose(kt.numpy(), np.asarray(kj), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(nt.numpy(), np.asarray(nj), rtol=0,
                                   atol=1e-5)
        fac = jglr.dft_spatial_factors(ny, nx, fshape2, (9, 9))
        cj = jglr.glr_spatial_matmul(
            jnp.asarray(cube), jnp.real(kj), jnp.imag(kj),
            None if wmaps is None else jnp.asarray(wmaps),
            {k: jnp.asarray(v) for k, v in fac.items()})
        ct = tglr.glr_spatial_matmul(
            _t(cube), _t(np.real(kj)), _t(np.imag(kj)),
            None if wmaps is None else _t(wmaps),
            {k: _t(v) for k, v in fac.items()})
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=0,
                                   atol=1e-5)


def test_fused_pair_auto_even_spaxel_count():
    """48 spaxels: the grid's lower end is the median of an even count,
    which jnp.median takes as the mean of the two middle values."""
    rng = np.random.default_rng(9)
    shape = (40, 6, 8)

    def sparse():
        a = rng.normal(size=shape).astype(np.float32) * 2 + 3
        a[rng.random(shape) < 0.8] = 0.0
        return a

    cubes = [sparse() for _ in range(4)]
    segmask = (rng.random(shape[1:]) < 0.7).astype(np.float32)
    outj = jpur._fused_pair_auto(*(jnp.asarray(c) for c in cubes[:2]),
                                 jnp.asarray(segmask),
                                 *(jnp.asarray(c) for c in cubes[2:]))
    outt = tpur._fused_pair_auto(_t(cubes[0]), _t(cubes[1]), _t(segmask),
                                 _t(cubes[2]), _t(cubes[3]))
    # (grid, n_max counts, n_min counts) per cube pair: all exactly equal
    for a, b in zip(outt, outj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    med = tpur._median(torch.amax(_t(cubes[0]), dim=0))
    assert float(med) == float(jnp.median(jnp.amax(jnp.asarray(cubes[0]),
                                                   axis=0)))
    assert float(med) != float(torch.median(torch.amax(_t(cubes[0]), dim=0)))


def test_fused_pair_given_counts():
    rng = np.random.default_rng(10)
    cubes = [rng.normal(size=(20, 4, 5)).astype(np.float32) for _ in range(4)]
    segmask = (rng.random((4, 5)) < 0.5).astype(np.float32)
    th = np.linspace(-1, 2, 7).astype(np.float32)
    outj = jpur._fused_pair_given(*(jnp.asarray(c) for c in cubes[:2]),
                                  jnp.asarray(segmask),
                                  *(jnp.asarray(c) for c in cubes[2:]),
                                  jnp.asarray(th))
    outt = tpur._fused_pair_given(_t(cubes[0]), _t(cubes[1]), _t(segmask),
                                  _t(cubes[2]), _t(cubes[3]), _t(th))
    for a, b in zip(outt, outj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_detection_order_matches_np_where():
    from origin_tpu_torch.pipeline.engine import TorchEngine
    from origin_tpu_torch.pipeline.products import TensorCube

    rng = np.random.default_rng(11)
    arr = rng.normal(size=(12, 5, 7)).astype(np.float32)
    prof = rng.integers(0, 3, size=arr.shape).astype(np.uint8)

    class _Store:
        def __init__(self, val):
            self.val = val

        def peek(self, name):
            return self.val

    class _Owner:
        def __init__(self, val):
            self.store = _Store(TensorCube(_t(val)))

    class _Orig:
        _product_owner = {"a": _Owner(arr), "p": _Owner(prof)}

    eng = TorchEngine(_Orig(), "cpu")
    (z, y, x), vals, (pv,) = eng.detections_above("a", 1.1, ("p",))
    ez, ey, ex = np.where(arr > np.float32(1.1))
    np.testing.assert_array_equal(z, ez)
    np.testing.assert_array_equal(y, ey)
    np.testing.assert_array_equal(x, ex)
    np.testing.assert_array_equal(vals, arr[ez, ey, ex])
    np.testing.assert_array_equal(pv, prof[ez, ey, ex])
    (z, _, _), vals, _ = eng.detections_above("a", np.inf)
    assert z.size == 0 and vals.size == 0


def test_compute_pca_threshold_matches():
    rng = np.random.default_rng(12)
    area = rng.normal(size=(80, 400)) * rng.uniform(0.8, 1.2, size=400)
    for a, b in zip(tpca.compute_pca_threshold(area, 0.01, device="cpu"),
                    jpca.compute_pca_threshold(area, 0.01)):
        np.testing.assert_array_equal(a, b)


def test_state_from_numpy():
    from origin_tpu_torch.convert import state_from_numpy

    t_num, t_den, pad_left, _ = jglr.pack_profiles_toeplitz(
        jglr.prepare_profiles([np.exp(-0.5 * (np.arange(21) - 10.0) ** 2)]),
        block=16)
    fac = jglr.dft_spatial_factors(6, 5, (14, 13), (9, 9))
    state = state_from_numpy(dict(
        t_num=t_num, t_den=t_den, pad_left=np.int64(pad_left), factors=fac,
        psfs=np.ones((1, 4, 9, 9)), areamap=np.ones((6, 5), np.int64),
        testO2=[np.arange(3.0), np.arange(2.0)], thresholds=[1.5, 2.5],
        mask=np.zeros((2, 2), bool), idx=np.arange(4, dtype=np.uint32),
    ), "cpu")
    assert state["t_num"].dtype == torch.float32
    np.testing.assert_array_equal(state["t_num"].numpy(), t_num)
    assert state["pad_left"] == pad_left and type(state["pad_left"]) is int
    assert set(state["factors"]) == set(fac)
    assert state["psfs"].dtype == torch.float32  # float64 -> float32
    assert state["areamap"].dtype == torch.int64
    assert [t.dtype for t in state["testO2"]] == [torch.float32] * 2
    assert state["thresholds"] == [1.5, 2.5]
    assert state["mask"].dtype == torch.bool
    assert state["idx"].dtype == torch.int64  # no wide unsigned in torch


def test_inputs_derived_on_device_match_host_views(tmp_path):
    """A cube without NaNs uploads its raw data and variance and derives
    the filled views on the device; they equal the host views."""
    from origin_tpu_torch.core import Cube
    from origin_tpu_torch.pipeline.session import ORIGIN
    from tools_torch.synthetic import make_minicube

    base = make_minicube(None, nz=40, ny=10, nx=12)
    data = np.nan_to_num(base.data, nan=0.5)
    var = np.array(base.var)
    var[3, 2, 2] = np.inf  # a non-finite variance without a data NaN
    cube = Cube(data=data, var=var, wcs=base.wcs, wave=base.wave,
                primary_header=base.primary_header)
    assert cube.mask is None
    orig = ORIGIN.init(cube, device="cpu", path=str(tmp_path), name="d",
                       loglevel="WARNING")
    np.testing.assert_array_equal(orig.engine.input_cube().numpy(),
                                  orig.cube_raw)
    np.testing.assert_array_equal(orig.engine.input_var().numpy(), orig.var)
    np.testing.assert_array_equal(orig.engine.input_mask().numpy(),
                                  orig.mask)
    with pytest.raises(KeyError, match="unknown state"):
        orig.engine.load_state({"t_num": np.zeros(3)})
    orig.close_logfile()
