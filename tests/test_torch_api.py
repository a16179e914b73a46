"""The port's function-level library surface against the JAX package's.

- Names: every key of ``origin_tpu._REF_PARITY`` resolves on
  ``origin_tpu_torch`` (to a callable, ``STEPS`` excepted) and is in its
  ``dir()``; every name of the ``__all__`` of ``origin_tpu.ops``,
  ``.core``, ``.detect``, ``.artifacts`` and ``.parallel`` resolves in
  the port's module of the same name, also in a process where ``jax``,
  ``yaml`` and ``origin_tpu`` cannot be imported.
- The GLR stages: the same numpy inputs go through the JAX function and
  the port's on the CPU (the port's plain versions).  Values at atol
  1e-5, as the JAX package holds its sweeps (the frameworks sum in
  different orders); profile indices equal, with the same dtype.  The
  spectral sweeps take the inputs of tests/test_torch_sweep.py (nz = 200,
  not a multiple of the 128-channel block), the 3- and 20-profile
  dictionaries.  On a cube with a NaN, the plain versions give the JAX
  package's NaNs.
- The purity threshold: the same threshold and table, exactly.
- The area-wise greedy PCA: against the JAX function with its power
  iteration run to its whole budget (tests/jax_full_budget.py), as the
  step-04 tests hold it: mapO2 and nstop equal, faint at atol 1e-4.

The JAX package is imported inside the CPU tests only (the ``jx``
fixture), so that the ``gpu`` cases run on a machine without it:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_api.py
"""

import importlib
import logging
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest
import torch

import origin_tpu_torch
from origin_tpu_torch import fitsio as tfits
from origin_tpu_torch.core import Cube, Image, MoffatFSF, gaussian_profile
from origin_tpu_torch.core.profiles import (
    DICO_3FWHM, DICO_FWHM_2_12, default_dictionary_path, load_dictionary,
)
from origin_tpu_torch.ops import glr as tglr
from origin_tpu_torch.ops import kernels, pca as tpca, purity as tpur
from origin_tpu_torch.ops.convolve import fft2_shape, fftconvolve2d_same
from origin_tpu_torch.ops.sweep import spectral_sweep
from origin_tpu_torch.utils import timeit
from test_torch_gpu import (  # noqa: F401
    _assert_ties, _hold, _problem, _profiles, _same_bits, cuda,
)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ("ops", "core", "detect", "artifacts", "parallel")
DICOS = (DICO_3FWHM, DICO_FWHM_2_12)
ATOL = 1e-5


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules that these tests hold the port to."""
    import jax.numpy as jnp

    import origin_tpu
    from origin_tpu import fitsio
    from origin_tpu.core import containers
    from origin_tpu.ops import convolve, glr, pca, purity

    return types.SimpleNamespace(jnp=jnp, origin_tpu=origin_tpu,
                                 fitsio=fitsio, containers=containers,
                                 convolve=convolve, glr=glr, pca=pca,
                                 purity=purity)


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_glr_equal(ours, ref, atol=ATOL):
    """(correl, profile, correl_min) of both packages: values at ``atol``
    (NaN where the other is NaN), indices equal, with the same dtype."""
    (c, p, m), (cr, pr, mr) = ([np.asarray(a) for a in out]
                               for out in (ours, ref))
    np.testing.assert_allclose(c, cr, rtol=0, atol=atol)
    np.testing.assert_allclose(m, mr, rtol=0, atol=atol)
    assert p.dtype == pr.dtype
    np.testing.assert_array_equal(p, pr)


# -- the names -----------------------------------------------------------------
def test_ref_parity_names_resolve(jx):
    ref = jx.origin_tpu._REF_PARITY
    assert set(origin_tpu_torch._REF_PARITY) == set(ref)
    names = dir(origin_tpu_torch)
    for name in ref:
        obj = getattr(origin_tpu_torch, name)
        assert callable(obj) or name == "STEPS", name
        assert name in names, name
    assert len(origin_tpu_torch.STEPS) == 11
    # the canonical homes
    from origin_tpu_torch.detect import spatiospectral_merging
    from origin_tpu_torch.ops import correlation_glr_test

    assert origin_tpu_torch.spatiospectral_merging is spatiospectral_merging
    assert origin_tpu_torch.Correlation_GLR_test is correlation_glr_test
    assert origin_tpu_torch.estimation_line is (
        origin_tpu_torch.ops.estimation_line_arrays)


def test_top_level_containers_and_submodules(jx):
    names = dir(origin_tpu_torch)
    for name in ("Cube", "Image", "Spectrum", "Table", "WCS", "WaveCoord",
                 "MoffatFSF", "FieldsMap"):
        assert hasattr(jx.origin_tpu, name)
        obj = getattr(origin_tpu_torch, name)
        assert obj is getattr(origin_tpu_torch.core, name) and name in names
    for name in ("steps", "ops", "detect", "artifacts", "pipeline",
                 "parallel"):
        mod = getattr(origin_tpu_torch, name)
        assert mod.__name__.startswith("origin_tpu_torch.") and name in names
    assert origin_tpu_torch.steps is importlib.import_module(
        "origin_tpu_torch.pipeline.steps")
    with pytest.raises(AttributeError):
        origin_tpu_torch.no_such_name  # noqa: B018


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_subpackage_all_resolves(sub, jx):
    ref = importlib.import_module("origin_tpu." + sub)
    mod = importlib.import_module("origin_tpu_torch." + sub)
    missing = [n for n in ref.__all__ if not hasattr(mod, n)]
    assert not missing
    assert set(ref.__all__) <= set(mod.__all__)


def test_surface_resolves_without_jax_or_yaml(jx):
    names = {sub: list(importlib.import_module("origin_tpu." + sub).__all__)
             for sub in SUBPACKAGES}
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in ("jax", "yaml", "origin_tpu"):
            sys.modules[name] = None
        sys.path[:0] = [{REPO!r}]
        import origin_tpu_torch as t
        for name in {sorted(jx.origin_tpu._REF_PARITY)!r}:
            assert callable(getattr(t, name)) or name == "STEPS", name
        for sub, names in {names!r}.items():
            mod = importlib.import_module("origin_tpu_torch." + sub)
            for name in names:
                getattr(mod, name)
        t.Cube, t.Table, t.FieldsMap
        # the lookups build no kernel
        from origin_tpu_torch.ops import build
        assert not build._LIBS and not build.BUILD_INFO
        print("OK")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("OK")


# -- the spatial stage ------------------------------------------------------------
def _spatial_inputs(nz=37, ny=11, nx=9, psf_size=7, nfields=1, seed=3):
    rng = np.random.default_rng(seed)
    cube = rng.normal(size=(nz, ny, nx)).astype(np.float32)
    fsf = MoffatFSF(fwhm_pol=[-0.2, 0.7], beta_pol=[2.8], pixstep=0.2)
    psf = fsf.get_3darray(4750 + 1.25 * np.arange(nz),
                          (psf_size, psf_size)).astype(np.float32)
    psfs = np.stack([psf * (1 + 0.1 * f) for f in range(nfields)])
    wmaps = (None if nfields == 1 else rng.uniform(
        0.2, 1.0, size=(nfields, ny, nx)).astype(np.float32))
    return cube, psfs, wmaps, fft2_shape((ny, nx), (psf_size, psf_size))


def test_fftconvolve2d_same_matches_jax(jx):
    cube, psfs, _, fshape2 = _spatial_inputs()
    ours = fftconvolve2d_same(_t(cube), _t(psfs[0]), fshape2)
    ref = jx.convolve.fftconvolve2d_same(jx.jnp.asarray(cube),
                                         jx.jnp.asarray(psfs[0]), fshape2)
    assert ours.shape == cube.shape
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                               atol=ATOL)


@pytest.mark.parametrize("nfields", [1, 2])
def test_glr_spatial_matches_jax(nfields, jx):
    cube, psfs, wmaps, fshape2 = _spatial_inputs(nfields=nfields)
    jn = jx.jnp.asarray
    jw = None if wmaps is None else jn(wmaps)
    tw = None if wmaps is None else _t(wmaps)
    ours = tglr.glr_spatial(_t(cube), _t(psfs), tw, fshape2)
    ref = jx.glr.glr_spatial(jn(cube), jn(psfs), jw, fshape2)
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float32 and a.is_contiguous()
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=ATOL)
    ny, nx = cube.shape[1:]
    kern_hats, _ = tglr.precompute_spatial(_t(psfs), tw, ny, nx, fshape2)
    pre = tglr.glr_spatial_pre(_t(cube), kern_hats, tw, psfs.shape[-2:],
                               fshape2)
    jkern, _ = jx.glr.precompute_spatial(jn(psfs), jw, ny, nx, fshape2)
    jpre = jx.glr.glr_spatial_pre(jn(cube), jkern, jw, psfs.shape[-2:],
                                  fshape2)
    np.testing.assert_allclose(pre.numpy(), np.asarray(jpre), rtol=0,
                               atol=ATOL)
    # the two routes of the port compute one correlation
    np.testing.assert_allclose(pre.numpy(), ours[0].numpy(), rtol=0,
                               atol=ATOL)


# -- the spectral stage -----------------------------------------------------------
def _sweep_inputs(nz=200, ny=4, nx=5, seed=0):
    """The inputs of tests/test_torch_sweep.py."""
    rng = np.random.default_rng(seed)
    cf = rng.normal(size=(nz, ny, nx)).astype(np.float32)
    nf = rng.uniform(0.5, 2.0, size=(nz, ny, nx)).astype(np.float32)
    return cf, nf


def _prepped(dico):
    profiles, _ = load_dictionary(default_dictionary_path(dico))
    return tglr.prepare_profiles(profiles)


@pytest.mark.parametrize("dico", DICOS)
def test_pack_profiles_matches_jax(dico, jx):
    prepped = _prepped(dico)
    ours, ref = tglr._pack_profiles(prepped), jx.glr._pack_profiles(prepped)
    for a, b in zip(ours[:2], ref[:2]):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    assert ours[2] == ref[2]
    wide = tglr._pack_profiles(prepped, length=ours[0].shape[1] + 3)
    np.testing.assert_array_equal(wide[0][:, :ours[0].shape[1]], ours[0])
    assert not wide[0][:, ours[0].shape[1]:].any()


@pytest.mark.parametrize("dico", DICOS)
def test_glr_spectral_matches_jax(dico, jx):
    nz = 200
    cf, nf = _sweep_inputs(nz=nz)
    bank, bank2, centers = tglr._pack_profiles(_prepped(dico))
    before = kernels.matched_filter_spectral.launches
    ours = tglr.glr_spectral(_t(cf), _t(nf), bank, bank2, centers, nz)
    assert kernels.matched_filter_spectral.launches == before  # CPU: plain
    jn = jx.jnp.asarray
    ref = jx.glr.glr_spectral(jn(cf), jn(nf), jn(bank), jn(bank2), centers,
                              nz)
    _assert_glr_equal([o.numpy() for o in ours], ref)
    assert ours[1].dtype == torch.uint8
    assert int(ours[1].max()) == len(centers) - 1  # every profile can win
    assert all(o.is_contiguous() and o.shape == cf.shape for o in ours)


@pytest.mark.parametrize("dico", DICOS)
def test_glr_spectral_mxu_matches_jax(dico, jx):
    nz = 200
    cf, nf = _sweep_inputs(nz=nz)
    t_num, t_den, pad_left, _ = tglr.pack_profiles_toeplitz(
        _prepped(dico), block=min(128, nz))
    ours = tglr.glr_spectral_mxu(_t(cf), _t(nf), t_num, t_den, pad_left, nz)
    jn = jx.jnp.asarray
    ref = jx.glr.glr_spectral_mxu(jn(cf), jn(nf), jn(t_num), jn(t_den),
                                  pad_left, nz)
    _assert_glr_equal([o.numpy() for o in ours], ref)
    # the port's two spectral entries compute one statistic
    bank, bank2, centers = tglr._pack_profiles(_prepped(dico))
    mf = tglr.glr_spectral(_t(cf), _t(nf), bank, bank2, centers, nz)
    _assert_glr_equal([o.numpy() for o in ours], [o.numpy() for o in mf])


def test_glr_spectral_wide_bank_indices_are_int32(jx):
    nz = 64
    cf, nf = _sweep_inputs(nz=nz, seed=4)
    rng = np.random.default_rng(5)
    prepped = [(p, (len(p) - 1) // 2) for p in
               (rng.normal(size=1 + (5 * k) % 21) for k in range(260))]
    bank, bank2, centers = tglr._pack_profiles(prepped)
    ours = tglr.glr_spectral(_t(cf), _t(nf), bank, bank2, centers, nz)
    jn = jx.jnp.asarray
    ref = jx.glr.glr_spectral(jn(cf), jn(nf), jn(bank), jn(bank2), centers,
                              nz)
    assert ours[1].dtype == torch.int32
    _assert_glr_equal([o.numpy() for o in ours], ref)


# -- the orchestrator ---------------------------------------------------------------
def _glr_case(case, nz):
    """(cube, fsf, weights, profiles): test_ops.py's single-field problem
    (its two Gaussian profiles, or a dictionary) and its mosaic of two
    fields with complementary weights."""
    rng = np.random.default_rng(11 if case != "mosaic" else 12)
    ny, nx = (9, 8) if case != "mosaic" else (8, 8)
    cube = rng.normal(size=(nz, ny, nx)).astype(np.float32)
    lbda = np.linspace(5000, 9000, nz)
    if case == "mosaic":
        fsf = MoffatFSF(fwhm_pol=[0.6], beta_pol=[2.8], pixstep=0.2)
        psf = fsf.get_3darray(lbda, (5, 5)).astype(np.float32)
        w1 = np.zeros((ny, nx), np.float32)
        w1[:, :4] = 1
        return cube, [psf, psf], [w1, 1 - w1], [gaussian_profile(4.0, 31, 15)]
    fsf = MoffatFSF(fwhm_pol=[0.2, 0.6], beta_pol=[2.8], pixstep=0.2)
    psf = fsf.get_3darray(lbda, (7, 7)).astype(np.float32)
    if case == "gauss":
        profiles = [gaussian_profile(f, 41, 20) for f in (2.0, 6.0)]
    else:
        profiles, _ = load_dictionary(default_dictionary_path(case))
    return cube, psf, None, profiles


@pytest.mark.parametrize("case,nz", [("gauss", 60), (DICO_3FWHM, 150),
                                     (DICO_FWHM_2_12, 150), ("mosaic", 40)])
def test_correlation_glr_test_matches_jax(case, nz, jx):
    cube, fsf, weights, profiles = _glr_case(case, nz)
    before = spectral_sweep.launches
    ours = tglr.correlation_glr_test(cube, fsf, weights, profiles,
                                     device="cpu")
    assert spectral_sweep.launches == before  # CPU: the plain sweep
    ref = jx.glr.correlation_glr_test(cube, fsf, weights, profiles)
    assert all(isinstance(o, np.ndarray) and o.flags.writeable
               for o in ours)
    _assert_glr_equal(ours, ref)
    assert ours[1].dtype == np.uint8


def test_correlation_glr_test_nan_cube_matches_jax(jx):
    """A NaN voxel: the DFT-by-matmul spreads it over its channel and the
    plain sweep over the windows that read that channel, in both
    packages."""
    cube, fsf, _, profiles = _glr_case(DICO_3FWHM, 150)
    cube[70, 4, 3] = np.nan
    ours = tglr.correlation_glr_test(cube, fsf, None, profiles,
                                     device="cpu")
    ref = jx.glr.correlation_glr_test(cube, fsf, None, profiles)
    nan = np.isnan(np.asarray(ref[0]))
    assert nan.any() and not nan.all()
    np.testing.assert_array_equal(np.isnan(ours[0]), nan)
    np.testing.assert_array_equal(np.isnan(ours[2]),
                                  np.isnan(np.asarray(ref[2])))
    _assert_glr_equal(ours, ref)


def test_correlation_glr_test_device_is_explicit(monkeypatch):
    cube, fsf, _, profiles = _glr_case("gauss", 60)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tglr.correlation_glr_test(cube, fsf, None, profiles)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpca.greedy_pca_by_area(cube, np.ones(cube.shape[1:], int), [1.0],
                                [np.ones(cube[0].size)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpur.compute_threshold_purity(0.8, cube, cube)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpca.compute_pca_threshold(cube[:, 0], 0.01)


# -- purity ------------------------------------------------------------------------
def _purity_cubes(seed=9, shape=(40, 6, 8), nan=False):
    rng = np.random.default_rng(seed)

    def sparse(loc):
        a = rng.normal(size=shape).astype(np.float32) * 2 + loc
        a[rng.random(shape) < 0.8] = 0.0
        return a

    # the local maxima hold higher values than the minima (lines)
    cmax, cmin = sparse(3.5), sparse(3.0)
    cmax.ravel()[rng.choice(cmax.size, 8, replace=False)] = rng.uniform(
        12.0, 20.0, 8).astype(np.float32)
    segmap = (rng.random(shape[1:]) < 0.3) * rng.integers(1, 4, shape[1:])
    if nan:  # NaN x 0 stays NaN, counted nowhere (and a NaN max)
        cmin[5, segmap > 0] = np.nan
    return cmax, cmin, segmap


def _assert_tables_equal(ours, ref):
    (t, tab), (tr, tabr) = ours, ref
    np.testing.assert_equal(t, tr)
    assert tab.colnames == tabr.colnames
    for name in tab.colnames:
        a, b = np.asarray(tab[name]), np.asarray(tabr[name])
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("segmap", [False, True])
@pytest.mark.parametrize("threshlist", [None, [4.2, 3.0, 3.5, 5.0, 6.1]])
def test_compute_threshold_purity_matches_jax(segmap, threshlist, jx):
    cmax, cmin, seg = _purity_cubes(nan=threshlist is not None)
    seg = seg if segmap else None
    finite = 0
    for purity in (0.1, 0.5, 0.8):
        ref = jx.purity.compute_threshold_purity(purity, cmax, cmin, seg,
                                                 threshlist)
        finite += np.isfinite(ref[0])
        ours = tpur.compute_threshold_purity(purity, cmax, cmin, seg,
                                             threshlist, device="cpu")
        _assert_tables_equal(ours, ref)
        tensors = tpur.compute_threshold_purity(purity, _t(cmax), _t(cmin),
                                                seg, threshlist)
        _assert_tables_equal(tensors, ref)
    assert finite  # some purity is reached on the grid


def test_compute_threshold_purity_on_the_pair_grid():
    """Given step 06's grid, the single form gives step 06's correl
    threshold and table exactly."""
    cmax, cmin, seg = _purity_cubes(seed=10)
    smax, smin, _ = _purity_cubes(seed=11)
    thr, pval, _, _ = tpur.compute_threshold_purity_pair(
        0.8, _t(cmax), _t(cmin), _t(smax), _t(smin), seg)
    assert np.isfinite(thr) and np.all(np.diff(pval["Tval_r"]) > 0)
    single = tpur.compute_threshold_purity(
        0.8, _t(cmax), _t(cmin), seg, threshlist=np.asarray(pval["Tval_r"]))
    _assert_tables_equal(single, (thr, pval))


# -- PCA -------------------------------------------------------------------------
def _area_problem(nz=48, ny=10, nx=12, seed=21):
    rng = np.random.default_rng(seed)
    cube = rng.normal(size=(nz, ny, nx)).astype(np.float32)
    spec = np.exp(-0.5 * ((np.arange(nz) - 24) / 6.0) ** 2)
    for (y, x), amp in (((1, 2), 10.0), ((2, 2), 8.0), ((7, 9), 12.0),
                        ((8, 3), 9.0)):
        cube[:, y, x] += amp * spec
    areamap = np.ones((ny, nx), np.int64)
    areamap[:, 6:] = 2
    areamap[5:, :6] = 3
    areamap[0, 0] = 0  # outside every area
    test = np.mean(cube.astype(np.float64) ** 2, axis=0)
    thresholds, testO2 = [], []
    for a in (1, 2, 3):
        t = test[areamap == a].astype(np.float32)
        testO2.append(t)
        thresholds.append(float(np.percentile(t, 80.0)))
    return cube, areamap, thresholds, testO2


def test_greedy_pca_by_area_matches_jax_full_budget(jx):
    from jax_full_budget import jax_full_budget

    cube, areamap, thresholds, testO2 = _area_problem()
    with jax_full_budget():
        fj, mj, kj = jx.pca.greedy_pca_by_area(cube, areamap, thresholds,
                                               testO2)
    ft, mt, kt = tpca.greedy_pca_by_area(cube, areamap, thresholds, testO2,
                                         device="cpu")
    assert isinstance(ft, np.ndarray) and ft.dtype == np.float32
    assert mt.dtype == np.int32 and mt.shape == areamap.shape
    np.testing.assert_array_equal(mt, mj)
    assert kt == kj == 0
    assert mj.max() >= 2  # the loop ran real iterations
    np.testing.assert_allclose(ft, fj, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(ft[:, 0, 0], cube[:, 0, 0])


def test_compute_pca_threshold_matches_jax(jx):
    cube, areamap, _, _ = _area_problem()
    cols = cube[:, areamap == 1]
    ours = tpca.compute_pca_threshold(cols, 0.01, device="cpu")
    ref = jx.pca.compute_pca_threshold(cols, 0.01)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


# -- the host substrate -------------------------------------------------------------
def test_containers_abs_and_get_mask(jx):
    rng = np.random.default_rng(7)
    data = rng.normal(size=(5, 4, 3)).astype(np.float32)
    data[1, 2, 0] = np.nan
    for cls in (Cube, Image):
        jcls = getattr(jx.containers, cls.__name__)
        d = data if cls is Cube else data[0]
        ours, ref = cls(data=d, var=np.abs(d)), jcls(data=d, var=np.abs(d))
        a, b = ours.abs(), ref.abs()
        assert type(a) is cls and type(b).__name__ == cls.__name__
        np.testing.assert_array_equal(a.data, b.data)
        np.testing.assert_array_equal(a.get_mask(), b.get_mask())
        assert a.var is ours.var
        np.testing.assert_array_equal(ours.get_mask(), ref.get_mask())
    clean = Cube(data=np.abs(data[:, :2, :2]) + 1)
    assert clean.mask is None
    assert clean.get_mask().shape == clean.shape
    assert not clean.get_mask().any()


def test_writeto_round_trip(tmp_path, jx):
    rng = np.random.default_rng(8)
    data = rng.normal(size=(3, 4, 5)).astype(np.float32)
    hdr = tfits.Header()
    hdr["OBJECT"] = "field"
    ours, ref = tmp_path / "ours.fits", tmp_path / "ref.fits"
    tfits.writeto(str(ours), data, header=hdr)
    jhdr = jx.fitsio.Header()
    jhdr["OBJECT"] = "field"
    jx.fitsio.writeto(str(ref), data, header=jhdr)
    assert ours.read_bytes() == ref.read_bytes()
    for read in (tfits.getdata, jx.fitsio.getdata):
        np.testing.assert_array_equal(read(str(ours)), data)
    assert tfits.getheader(str(ours))["OBJECT"] == "field"
    with pytest.raises(Exception):
        tfits.writeto(str(ours), data, overwrite=False)


def test_timeit_logs_the_wall(caplog):
    @timeit
    def twice(x):
        return 2 * x

    with caplog.at_level(logging.DEBUG, logger=__name__):
        assert twice(21) == 42
    assert twice.__name__ == "twice"
    assert any("twice executed in" in r.getMessage() for r in caplog.records)


# -- on the card ----------------------------------------------------------------------
@pytest.mark.gpu
@pytest.mark.parametrize("dico", [*DICOS, "k260"])
def test_cuda_glr_spectral_launches_kernel_3(cuda, dico):
    """One launch of the spaxel-major kernel, held to its plain version by
    ``_hold``: a NaN sample and den <= 0 spaxels included, so the NaN
    footprint of the kernel is pinned through this entry too."""
    shape = (200, 9, 7)
    nz = shape[0]
    (x, n, t_num, t_den), pad_left = _problem(dico, *shape, cuda, nan=True)
    bank, bank2, centers = tglr._pack_profiles(
        _profiles(dico, np.random.default_rng(6)))
    before = kernels.matched_filter_spectral.launches
    got = tglr.glr_spectral(x, n, bank, bank2, centers, nz)
    torch.cuda.synchronize()
    assert kernels.matched_filter_spectral.launches == before + 1
    s = x[0].numel()
    cr, mr, pr = kernels.matched_filter_plain(
        x.reshape(nz, s).T.contiguous(), n.reshape(nz, s).T.contiguous(),
        torch.from_numpy(bank), torch.from_numpy(bank2), centers)
    back = lambda a: a.T.reshape(x.shape)  # noqa: E731
    _hold(got, (back(cr), back(pr).to(got[1].dtype), back(mr)), x, n, t_num,
          t_den, pad_left)
    # kernel 1 on the cube layout computes the same bits, NaN included
    ck, pk, mk = tglr.glr_spectral_mxu(x, n, t_num, t_den, pad_left, nz)
    assert _same_bits(got[0], ck) and _same_bits(got[2], mk)
    assert torch.equal(got[1].to(torch.int32), pk.to(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("case,nz", [(DICO_3FWHM, 150), ("mosaic", 40)])
def test_cuda_correlation_glr_test_launches_kernel_1(cuda, case, nz):
    """One launch of the sweep kernel; the result held to the plain sweep
    on the card's spatial stage: values at atol 1e-5 + rtol 1e-5, indices
    equal but at near-ties, as ``_hold`` holds them."""
    cube, fsf, weights, profiles = _glr_case(case, nz)
    before = spectral_sweep.launches
    got = tglr.correlation_glr_test(cube, fsf, weights, profiles)
    assert spectral_sweep.launches == before + 1
    psfs = np.stack(fsf) if weights is not None else fsf[None]
    wmaps = None if weights is None else _t(np.stack(weights)).to(cuda)
    ny, nx = cube.shape[1:]
    fshape2 = fft2_shape((ny, nx), psfs.shape[-2:])
    kern_r, kern_i, factors, norm = tglr.spatial_operands(
        _t(psfs).to(cuda), wmaps, ny, nx, fshape2)
    cube_fsf = tglr.glr_spatial_matmul(_t(cube).to(cuda), kern_r, kern_i,
                                       wmaps, factors)
    t_num, t_den, pad_left, _ = tglr.pack_profiles_toeplitz(
        tglr.prepare_profiles(profiles), block=min(128, nz))
    t_num, t_den = _t(t_num).to(cuda), _t(t_den).to(cuda)
    (c, p, m), (cr, pr, mr) = ((_t(a).to(cuda) for a in got),
                               tglr.toeplitz_sweep(cube_fsf, norm, t_num,
                                                   t_den, pad_left, nz))
    assert p.dtype == pr.dtype == torch.uint8
    torch.testing.assert_close(c, cr, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(m, mr, atol=1e-5, rtol=1e-5)
    _assert_ties(p, pr, cube_fsf, norm, t_num, t_den, pad_left)
