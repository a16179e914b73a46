"""The step 10-11 modules of the torch port against the JAX package's.

Inputs from tests/sources_cases.py (numpy, seeded); the JAX functions run
on the CPU.  Tolerances:

- ``line_max_images``: exact, -inf outside the field and NaN from the
  slab in the same places (a max is exact);
- ``window_ori_stats``: the max map exact; the object-mean spectrum at
  rtol 1e-6 (float32 sums of a positive statistic in another order), with
  the same NaN positions (empty object masks, windows outside the field,
  NaN voxels);
- ``source_spectra`` (windows gathered at field coordinates) against
  ``source_spectra_kernel`` fed the padded triple that
  ``DeviceEngine.source_spectra`` builds: within 1e-5 of each row's
  largest finite magnitude, with the same NaN positions;
- the cutouts of ``core.containers`` and ``TensorCube.subcube``: exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sources_cases as sc
from origin_tpu.core import containers as jcont
from origin_tpu.ops import cutouts as jcut
from origin_tpu.ops import spectra as jspec
from origin_tpu_torch.core import containers as tcont
from origin_tpu_torch.core.coords import WCS, WaveCoord
from origin_tpu_torch.ops import cutouts, spectra
from origin_tpu_torch.pipeline.products import TensorCube

torch.set_num_threads(2)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("size", sc.SIZES)
def test_line_max_images_matches_jax(size):
    cube = sc.detection_cube()
    y0, x0, zlo, zhi = sc.line_jobs(size)
    got, valid = cutouts.line_max_images(_t(cube), y0, x0, zlo, zhi, size)
    slab = int(np.max(zhi - zlo)) + 1
    want, jvalid = jcut.line_max_images_kernel(
        jnp.asarray(cube), y0.astype(np.int32), x0.astype(np.int32),
        zlo.astype(np.int32), zhi.astype(np.int32), size, slab + 3)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    got, want = got.numpy(), np.asarray(want)
    assert np.isneginf(got).any() and np.isnan(got).any()
    assert np.isfinite(got).any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("size", sc.SIZES)
def test_window_ori_stats_matches_jax(size):
    cube = sc.detection_cube()
    y0, x0 = sc.window_starts(size)
    objm = sc.object_masks(size, len(y0))
    spec, maxmap = cutouts.window_ori_stats(_t(cube), y0, x0, objm, size)
    jspec_, jmax = jcut.window_ori_stats_kernel(
        jnp.asarray(cube), y0.astype(np.int32), x0.astype(np.int32),
        jnp.asarray(objm), size)
    np.testing.assert_array_equal(maxmap.numpy(), np.asarray(jmax))
    spec, jspec_ = spec.numpy(), np.asarray(jspec_)
    sc.same_nonfinite(spec, jspec_)
    assert np.isnan(spec).all(axis=1).any()  # cnt == 0 windows
    fin = np.isfinite(jspec_)
    assert fin.sum() > spec.size // 2
    np.testing.assert_allclose(spec[fin], jspec_[fin], rtol=1e-6)


def _jax_padded(case):
    """The padded triple and window starts of DeviceEngine.source_spectra
    (halo 32, pads 0 / inf / True)."""
    h = 32
    pad = ((0, 0), (h, h), (h, h))
    return (jnp.pad(jnp.asarray(case["cube"]), pad),
            jnp.pad(jnp.asarray(case["var"]), pad, constant_values=np.inf),
            jnp.pad(jnp.asarray(case["mask"]), pad, constant_values=True),
            h)


@pytest.mark.parametrize("has_psf", [True, False], ids=["psf", "no_psf"])
@pytest.mark.parametrize("size", sc.SIZES)
def test_source_spectra_matches_jax_padded(size, has_psf):
    case = sc.spectra_inputs(size)
    pd, pv, pm, h = _jax_padded(case)
    want = jspec.source_spectra_kernel(
        pd, pv, pm, jnp.asarray(case["y0"] + h, jnp.int32),
        jnp.asarray(case["x0"] + h, jnp.int32), jnp.asarray(case["objm"]),
        jnp.asarray(case["skym"]), jnp.asarray(case["wcube"]),
        jnp.asarray(case["lsrc"], jnp.int32), jnp.asarray(case["lw"]), size,
        has_psf)
    got = spectra.source_spectra(
        _t(case["cube"]), _t(case["var"]), _t(case["mask"]),
        _t(case["y0"]), _t(case["x0"]), _t(case["objm"]),
        _t(case["skym"]), _t(case["wcube"]), _t(case["lsrc"]),
        _t(case["lw"]), size, has_psf)
    assert sorted(got) == sorted(want)
    for key in want:
        sc.hold_rows(got[key].numpy(), want[key], 1e-5)
    # the inputs reach the NaN branches: white-light weights over a spaxel
    # masked at every channel, and windows outside the field
    assert np.isnan(got["white_s"].numpy()).all(axis=1).any()
    assert np.isnan(got["white_img"].numpy()).any()


@pytest.mark.parametrize("size", sc.SIZES)
def test_batched_source_spectra_matches_jax(size):
    """Chunks of 3 against the JAX package's chunks of 8: the same tags
    per source, values as in the kernel test."""
    case = sc.spectra_inputs(size)
    jobs = sc.spectra_jobs(case)
    pd, pv, pm, h = _jax_padded(case)
    want = jspec.batched_source_spectra(
        pd, pv, pm, [dict(j, y0=j["y0"] + h, x0=j["x0"] + h) for j in jobs],
        case["wcube"])
    got = spectra.batched_source_spectra(
        _t(case["cube"]), _t(case["var"]), _t(case["mask"]), jobs,
        case["wcube"], chunk=3)
    assert list(got) == list(want)
    for key, tags in want.items():
        assert list(got[key]) == list(tags)
        for tag, val in tags.items():
            pairs = zip(got[key][tag], val) if isinstance(val, tuple) \
                else [(got[key][tag], val)]
            for a, b in pairs:
                sc.hold_rows(np.asarray(a)[None], np.asarray(b)[None], 1e-5)


# -- cutouts of the containers ----------------------------------------------
CENTERS = [(5.0, 7.0), (2.5, 3.5), (0.4, 14.6), (-1.0, 7.0), (11.5, -2.0),
           (13.0, 16.0), (30.0, 40.0), (6.5, 7.5)]


@pytest.mark.parametrize("y, x", CENTERS)
@pytest.mark.parametrize("size", [4, 5, 7])
def test_cutout_window_matches_jax(y, x, size):
    assert tcont.cutout_window(y, x, size) == jcont.cutout_window(y, x, size)


def _cubes(seed=4):
    """The same (NZ, NY, NX) cube with variance, a mask and world
    coordinates in both packages."""
    from origin_tpu.core.coords import WCS as JWCS
    from origin_tpu.core.coords import WaveCoord as JWave

    rng = np.random.default_rng(seed)
    data = rng.normal(size=(sc.NZ, sc.NY, sc.NX)).astype(np.float32)
    var = rng.uniform(0.5, 2.0, data.shape).astype(np.float32)
    mask = rng.random(data.shape) < 0.05
    kw = dict(crpix=(3.0, 4.0), crval=(-30.0, 53.0))
    wave = dict(crpix=1.0, crval=4750.0, cdelt=1.25)
    ours = tcont.Cube(data=data, var=var, mask=mask, wcs=WCS(**kw),
                      wave=WaveCoord(**wave))
    ref = jcont.Cube(data=data, var=var, mask=mask, wcs=JWCS(**kw),
                     wave=JWave(**wave))
    return ours, ref


def _assert_same_container(a, b):
    assert type(a).__name__ == type(b).__name__
    for name in ("data", "var", "mask"):
        x, y = getattr(a, name), getattr(b, name)
        assert (x is None) == (y is None), name
        if x is not None:
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
    assert tuple(a.wcs.crpix) == tuple(b.wcs.crpix)
    assert tuple(a.wcs.crval) == tuple(b.wcs.crval)
    assert a.wcs.shape == b.wcs.shape
    if a.ndim == 3:
        np.testing.assert_array_equal(a.wave.coord(), b.wave.coord())


@pytest.mark.parametrize("y, x", CENTERS)
@pytest.mark.parametrize("size", [4, 7])
def test_cube_subcube_matches_jax(y, x, size):
    ours, ref = _cubes()
    _assert_same_container(ours.subcube((y, x), size),
                           ref.subcube((y, x), size))


@pytest.mark.parametrize("y, x", CENTERS[:4])
def test_cube_subcube_in_degrees_and_lbda_matches_jax(y, x):
    ours, ref = _cubes()
    (sky,) = ours.wcs.pix2sky([[y, x]])
    lbda = (4760.0, 4780.0)
    _assert_same_container(
        ours.subcube(tuple(sky), 5, lbda=lbda, unit_center="deg"),
        ref.subcube(tuple(sky), 5, lbda=lbda, unit_center="deg"))


@pytest.mark.parametrize("method", ["sum", "mean", "max"])
@pytest.mark.parametrize("y, x", CENTERS[:6])
def test_cube_get_image_matches_jax(y, x, method):
    ours, ref = _cubes()
    for cut in ((lambda c: c), (lambda c: c.subcube((y, x), 6))):
        a = cut(ours).get_image((3, 11), method=method)
        b = cut(ref).get_image((3, 11), method=method)
        _assert_same_container(a, b)


@pytest.mark.parametrize("y, x", CENTERS)
def test_image_subimage_matches_jax(y, x):
    ours, ref = _cubes()
    a, b = ours.get_image((0, 4)), ref.get_image((0, 4))
    for size in (3, 6):
        _assert_same_container(a.subimage((y, x), size),
                               b.subimage((y, x), size))
    _assert_same_container(a[2:9, 1:5], b[2:9, 1:5])
    _assert_same_container(ours[4:9, 2:10, 3:], ref[4:9, 2:10, 3:])


@pytest.mark.parametrize("unit", [None, "deg"])
@pytest.mark.parametrize("y, x", CENTERS)
@pytest.mark.parametrize("size", [4, 5, 7])
def test_tensor_cube_subcube_matches_host(y, x, size, unit):
    ours, _ = _cubes()
    cube = sc.detection_cube()
    host = tcont.Cube(data=cube, wcs=ours.wcs, wave=ours.wave)
    dev = TensorCube(_t(cube), wcs=ours.wcs, wave=ours.wave)
    center = (y, x)
    if unit is not None:
        (sky,) = ours.wcs.pix2sky([[y, x]])
        center = tuple(sky)
    _assert_same_container(dev.subcube(center, size, unit_center=unit),
                           host.subcube(center, size, unit_center=unit))
