"""The bf16x3 mode and the kernels of the port against the JAX package.

On the CPU each wrapper runs its plain version, which is held to the JAX
package's Pallas kernel in interpret mode on the same numpy inputs:

- the spatial FSF stage (``spatial_fsf`` against ``glr_spatial_pallas``):
  at ``highest`` atol 1e-5; in bf16x3 atol 1e-5 against JAX's bf16x3 and
  1e-4 against JAX's ``highest`` (the 3-pass error is ~1e-5 relative);
- the bf16x3 sweep (``spectral_sweep`` against ``toeplitz_sweep_pallas``):
  atol 1e-5, profile indices equal except where the two profiles'
  statistics lie within 1e-5 of each other (the frameworks sum in
  different orders);
- ``matched_filter_spectral`` and ``banded_matmul_spectral`` against the
  JAX entries of the same names, on the inputs of tests/test_ops.py, at
  atol 1e-5 with the same tie rule; the TPU banded kernel seeds its
  running max / min with profile 0 and the port with -inf / +inf, which
  agree, NaN and inf inputs included.

The CUDA kernels have no CPU mode: their tests are in
tests/test_torch_gpu.py, marked ``gpu``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import origin_tpu.ops.pallas_spatial as psp
from origin_tpu.core import MoffatFSF, gaussian_profile
from origin_tpu.ops import glr as jglr
from origin_tpu.ops.convolve import fft2_shape
from origin_tpu.ops.pallas_kernels import (
    banded_matmul_spectral as jax_banded,
    matched_filter_spectral as jax_mf,
)
from origin_tpu.ops.pallas_prec import split_bf16 as jax_split
from origin_tpu.ops.pallas_sweep import toeplitz_sweep_pallas
from origin_tpu_torch.core.profiles import (
    DICO_3FWHM, DICO_FWHM_2_12, default_dictionary_path, load_dictionary,
)
from origin_tpu_torch.ops import glr as tglr
from origin_tpu_torch.ops.kernels import (
    banded_matmul_spectral,
    matched_filter_spectral,
    mf_taps,
)
from origin_tpu_torch.ops.prec import split_bf16
from origin_tpu_torch.ops.spatial import spatial_fsf, spatial_kernel_admits
from origin_tpu_torch.ops.sweep import spectral_sweep, sweep_taps

torch.set_num_threads(2)

TIE = 1e-5


def test_split_matches_jax_bit_for_bit():
    rng = np.random.default_rng(0)
    a = (rng.normal(size=4096) * 10.0 ** rng.integers(-8, 8, 4096))
    a = np.concatenate([a, [0.0, -0.0, 1.0, 2.0 ** -130, 3.4e38]])
    a = a.astype(np.float32)
    hi, lo = split_bf16(torch.from_numpy(a))
    jhi, jlo = jax_split(jnp.asarray(a))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi, np.float32))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo, np.float32))


def _spatial_problem(nz, ny, nx, psf_size, nfields=1, seed=0):
    rng = np.random.default_rng(seed)
    cube = rng.normal(size=(nz, ny, nx)).astype(np.float32)
    fsf = MoffatFSF(fwhm_pol=[-0.2, 0.7], beta_pol=[2.8], pixstep=0.2)
    psf = fsf.get_3darray(4750 + 1.25 * np.arange(nz),
                          (psf_size, psf_size)).astype(np.float32)
    psfs = np.stack([psf * (1 + 0.1 * f) for f in range(nfields)])
    wmaps = (None if nfields == 1 else rng.uniform(
        0.2, 1.0, size=(nfields, ny, nx)).astype(np.float32))
    fshape2 = fft2_shape((ny, nx), (psf_size, psf_size))
    kern_hats, _ = jglr.precompute_spatial(
        jnp.asarray(psfs), None if wmaps is None else jnp.asarray(wmaps),
        ny, nx, fshape2)
    kr = np.array(jnp.real(kern_hats))
    ki = np.array(jnp.imag(kern_hats))
    factors = jglr.dft_spatial_factors(ny, nx, fshape2,
                                       (psf_size, psf_size))
    return cube, kr, ki, wmaps, factors


def _jax_spatial(cube, kr, ki, wmaps, factors, precision):
    prec = jax.lax.Precision.HIGHEST if precision == "highest" else precision
    return np.asarray(psp.glr_spatial_pallas(
        jnp.asarray(cube), jnp.asarray(kr), jnp.asarray(ki),
        None if wmaps is None else jnp.asarray(wmaps),
        {k: jnp.asarray(v) for k, v in factors.items()}, zt=8,
        interpret=True, precision=prec))


def _torch_spatial(cube, kr, ki, wmaps, factors, precision):
    t = torch.from_numpy
    return spatial_fsf(t(cube), t(kr), t(ki),
                       None if wmaps is None else t(wmaps),
                       {k: t(v) for k, v in factors.items()},
                       precision=precision).numpy()


@pytest.mark.parametrize("case", [
    dict(shape=(37, 20, 28), psf=7),
    dict(shape=(37, 20, 28), psf=7, nfields=2),  # mosaic, weighted
    dict(shape=(19, 16, 24), psf=5),  # Nz ragged against zt=8
])
@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
def test_spatial_plain_matches_jax_kernel(case, precision):
    prob = _spatial_problem(*case["shape"], case["psf"],
                            nfields=case.get("nfields", 1))
    ours = _torch_spatial(*prob, precision)
    ref = _jax_spatial(*prob, precision)
    assert ours.shape == case["shape"]
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    if precision == "bf16x3":
        np.testing.assert_allclose(ours, _jax_spatial(*prob, "highest"),
                                   rtol=0, atol=1e-4)
        # the split really happens: bf16x3 is not the float32 chain
        assert np.abs(ours - _torch_spatial(*prob, "highest")).max() > 0


def test_spatial_route_rule_is_the_jax_packages():
    for ny, nx in ((20, 28), (100, 200), (300, 300), (480, 480),
                   (520, 520), (600, 600), (100, 900)):
        fy, fx = fft2_shape((ny, nx), (25, 25))
        fxr = fx // 2 + 1
        assert spatial_kernel_admits(ny, nx, fy, fxr) == \
            psp.spatial_pallas_fits(ny, nx, fy, fxr), (ny, nx)
    assert spatial_kernel_admits(300, 300, 324, 163)
    assert not spatial_kernel_admits(600, 600, 625, 313)


def _sweep_problem(nz, ny, nx, fwhms, seed):
    rng = np.random.default_rng(seed)
    cf = rng.normal(size=(nz, ny, nx)).astype(np.float32)
    nf = rng.uniform(0.5, 2.0, size=(nz, ny, nx)).astype(np.float32)
    prepped = tglr.prepare_profiles(
        [gaussian_profile(f, 41, 20) for f in fwhms])
    t_num, t_den, pad_left, _ = tglr.pack_profiles_toeplitz(
        prepped, block=min(128, nz))
    return cf, nf, t_num, t_den, pad_left


def _dot64(a, taps, precision):
    """``a @ taps`` in float64 of the products both sides form: the
    float32 operands, or the three bf16x3 passes."""
    if precision != "bf16x3":
        return a.astype(np.float64) @ taps.astype(np.float64)
    (ah, al), (th, tl) = (
        tuple(v.double().numpy() for v in split_bf16(torch.from_numpy(u)))
        for u in (a.astype(np.float32), taps))
    return ah @ th + al @ th + ah @ tl


def _t_stat(x, n, t_num, t_den, pad_left, k, z, s, precision):
    """float64 statistic of profile k at (z, s) of spaxel-major x, n."""
    reach = t_num.shape[1] - t_num.shape[2] + 1
    zi = z + np.arange(reach) - pad_left
    ok = (zi >= 0) & (zi < x.shape[1])
    xs = np.where(ok, x[s, np.clip(zi, 0, x.shape[1] - 1)], 0.0)
    ns = np.where(ok, n[s, np.clip(zi, 0, x.shape[1] - 1)], 0.0)
    return (_dot64(xs, t_num[k, :reach, 0], precision)
            / np.sqrt(_dot64(ns, t_den[k, :reach, 0], precision)))


def _assert_indices_equal_but_ties(p, pr, x, n, t_num, t_den, pad_left,
                                   precision="highest"):
    """Spaxel-major (S, Nz) index arrays equal except at near-ties of the
    statistic both sides compute at ``precision``."""
    for s, z in zip(*np.nonzero(p != pr)):
        ta, tb = (_t_stat(x, n, t_num, t_den, pad_left, int(k[s, z]), z, s,
                          precision) for k in (p, pr))
        assert abs(ta - tb) <= TIE, (s, z, ta, tb)


@pytest.mark.parametrize("fwhms,seed", [((2.0, 6.0), 7),
                                        (tuple(np.linspace(2, 12, 20)), 3)])
def test_bf16x3_sweep_plain_matches_jax_kernel(fwhms, seed):
    nz = 260
    cf, nf, t_num, t_den, pad_left = _sweep_problem(nz, 9, 8, fwhms, seed)
    c, p, m = (a.numpy() for a in spectral_sweep(
        torch.from_numpy(cf), torch.from_numpy(nf), torch.from_numpy(t_num),
        torch.from_numpy(t_den), pad_left, nz, precision="bf16x3"))
    cr, pr, mr = (np.asarray(a) for a in toeplitz_sweep_pallas(
        jnp.asarray(cf), jnp.asarray(nf), jnp.asarray(t_num),
        jnp.asarray(t_den), pad_left, nz, interpret=True,
        precision="bf16x3"))
    np.testing.assert_allclose(c, cr, rtol=0, atol=1e-5)
    np.testing.assert_allclose(m, mr, rtol=0, atol=1e-5)
    assert p.dtype == pr.dtype == np.uint8
    flat = lambda a: a.reshape(nz, -1).T
    _assert_indices_equal_but_ties(flat(p), flat(pr), flat(cf), flat(nf),
                                   t_num, t_den, pad_left, "bf16x3")
    # the split really happens: bf16x3 is not the float32 sweep
    hi = tglr.toeplitz_sweep(torch.from_numpy(cf), torch.from_numpy(nf),
                             torch.from_numpy(t_num),
                             torch.from_numpy(t_den), pad_left, nz)
    assert np.abs(c - hi[0].numpy()).max() > 0


def _two_gaussians():
    return [gaussian_profile(f, 41, 20) for f in (2.0, 6.0)]


def test_matched_filter_plain_matches_jax_entry():
    # the inputs of tests/test_ops.py:648
    rng = np.random.default_rng(14)
    nz, ny, nx = 200, 4, 5
    s = ny * nx
    cf = rng.normal(size=(nz, ny, nx)).astype(np.float32)
    nf = rng.uniform(0.5, 2.0, size=(nz, ny, nx)).astype(np.float32)
    prepped = jglr.prepare_profiles(_two_gaussians())
    pb, p2b, centers = jglr._pack_profiles(prepped)
    x = np.ascontiguousarray(cf.reshape(nz, s).T)
    n = np.ascontiguousarray(nf.reshape(nz, s).T)
    before = matched_filter_spectral.launches
    c, m, p = (a.numpy() for a in matched_filter_spectral(
        torch.from_numpy(x), torch.from_numpy(n), pb, p2b, centers))
    assert matched_filter_spectral.launches == before  # plain version
    cr, mr, pr = (np.asarray(a) for a in jax_mf(
        jnp.asarray(x), jnp.asarray(n), pb, p2b, centers, tile_rows=8,
        interpret=True))
    np.testing.assert_allclose(c, cr, rtol=0, atol=1e-5)
    np.testing.assert_allclose(m, mr, rtol=0, atol=1e-5)
    assert p.dtype == pr.dtype == np.int32
    # the same banks in Toeplitz form, for the tie check
    t_num, t_den, pad_left, _ = tglr.pack_profiles_toeplitz(prepped,
                                                            block=128)
    _assert_indices_equal_but_ties(p, pr, x, n, t_num, t_den, pad_left)


@pytest.mark.parametrize("bank", [DICO_3FWHM, DICO_FWHM_2_12,
                                  "two_gaussians"])
def test_mf_taps_are_the_toeplitz_banks_taps(bank):
    """The matched filter's host-built taps are column 0 of the Toeplitz
    banks of the same profiles, bit for bit, cut to the same reach, with
    the same extents and pad: so both spaxel-major entries, and the
    float32 sweep, run the same FMAs in the same order."""
    profiles = (_two_gaussians() if bank == "two_gaussians" else
                load_dictionary(default_dictionary_path(bank))[0])
    prepped = tglr.prepare_profiles(profiles)
    pb, p2b, centers = jglr._pack_profiles(prepped)
    (taps_num, taps_den, start, length), pad = mf_taps(pb, p2b, centers)
    t_num, t_den, pad_left, _ = tglr.pack_profiles_toeplitz(prepped)
    ref = sweep_taps(torch.from_numpy(t_num), torch.from_numpy(t_den))
    assert pad == pad_left
    for got, want in zip((taps_num, taps_den, start, length), ref):
        assert got.dtype == want.numpy().dtype
        np.testing.assert_array_equal(got, want.numpy())


def _banded_inputs(nan=False):
    # the inputs of tests/test_ops.py:681
    rng = np.random.default_rng(15)
    nz, ny, nx = 300, 4, 5
    s = ny * nx
    cf = rng.normal(size=(nz, ny, nx)).astype(np.float32)
    nf = rng.uniform(0.5, 2.0, size=(nz, ny, nx)).astype(np.float32)
    prepped = tglr.prepare_profiles(
        [gaussian_profile(f, 41, 20) for f in (2.0, 5.0, 9.0)])
    t_num, t_den, pad_left, _ = tglr.pack_profiles_toeplitz(prepped,
                                                            block=128)
    x = np.ascontiguousarray(cf.reshape(nz, s).T)
    n = np.ascontiguousarray(nf.reshape(nz, s).T)
    if nan:
        x[3, 50] = np.nan   # NaN statistics across the band
        x[5, 120] = np.inf  # inf x zero band taps: NaN as well
        x[6, 200] = -np.inf
        n[7, :40] = 0.0     # den <= 0: the statistic is 0
        n[8, 10] = -1.0
    return x, n, t_num, t_den, pad_left, nz


@pytest.mark.parametrize("nan", [False, True])
def test_banded_plain_matches_jax_entry(nan):
    x, n, t_num, t_den, pad_left, nz = _banded_inputs(nan)
    c, m, p = (a.numpy() for a in banded_matmul_spectral(
        torch.from_numpy(x), torch.from_numpy(n), t_num, t_den, pad_left,
        nz))
    cr, mr, pr = (np.asarray(a) for a in jax_banded(
        jnp.asarray(x), jnp.asarray(n), t_num, t_den, pad_left, nz,
        tile_rows=8, interpret=True))
    assert p.dtype == pr.dtype == np.int32
    for a, b in ((c, cr), (m, mr)):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                                   rtol=0, atol=1e-5)
    if nan:
        assert np.isnan(c).sum() > 0 and (c[7, :5] == 0).all()
        # at a NaN both seedings keep profile 0 (no t > NaN)
        np.testing.assert_array_equal(p[np.isnan(cr)], 0)
        np.testing.assert_array_equal(p, pr)
    else:
        _assert_indices_equal_but_ties(p, pr, x, n, t_num, t_den, pad_left)


def test_the_two_seedings_agree():
    """Seeding the running max / min with profile 0's statistic (the TPU
    banded kernel) or with -inf / +inf (the port) gives the same max,
    argmax and min, for every ordering of finite, infinite and NaN t."""
    vals = np.array([np.nan, -np.inf, -1.0, 0.0, 2.0, np.inf],
                    np.float32)
    grid = np.array(np.meshgrid(vals, vals, vals, indexing="ij"))
    t = torch.from_numpy(grid.reshape(3, -1))

    def fold(best, low, arg, start):
        for k in range(start, t.shape[0]):
            arg = torch.where(t[k] > best, k, arg)
            best = torch.maximum(best, t[k])
            low = torch.minimum(low, t[k])
        return best, low, arg

    zero = torch.zeros(t.shape[1], dtype=torch.int32)
    a = fold(t[0], t[0], zero, 1)
    b = fold(torch.full_like(t[0], -np.inf), torch.full_like(t[0], np.inf),
             zero, 0)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u.numpy(), v.numpy())
