"""The bf16x3 mode of the port's step 05 and of its steps 01-07.

``ORIGIN_TPU_PRECISION=bf16x3`` makes ``TorchEngine.tglr`` take the JAX
engine's route of that mode (``origin_tpu/pipeline/engine.py:1025-1032``):
the spatial FSF stage in ``spatial_fsf`` (its plain version on the CPU)
and the sweep at bf16x3.

- Step 05 on a cut of the minicube's ``cube_faint`` against the JAX chain
  of that mode run on the CPU: ``precompute_spatial``,
  ``glr_spatial_pallas(interpret=True, precision="bf16x3")``,
  ``toeplitz_sweep_pallas(interpret=True, precision="bf16x3")`` and
  ``_mask_extrema``.  The correl cube and the maxmap at atol 5e-5, the
  profile cube exactly and the local-maxima positions equal.  Not 1e-5:
  the bf16 split is not continuous, so a one-ulp difference in a float32
  intermediate (the two frameworks sum in different orders) can move a
  ``lo`` half by one bf16 step, 2^-16 of the value; the spatial stage
  then differs by ~1.5e-6 on values ~1, and the statistic, which divides
  by sqrt(norm) ~ 0.09, by up to 2.77e-5 (measured on this cut).  Each
  stage alone holds 1e-5 (tests/test_torch_kernels.py).
- Steps 01-07 of the minicube in bf16x3 give the goldens' counts, Cat0 15
  and Cat1 14, and the thresholds of the ``highest`` run within 1e-3.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from make_minicube import make_minicube, make_segmap
from origin_tpu.ops.glr import (
    dft_spatial_factors,
    pack_profiles_toeplitz,
    precompute_spatial,
    prepare_profiles,
)
from origin_tpu.ops.convolve import fft2_shape
from origin_tpu.ops.pallas_spatial import glr_spatial_pallas
from origin_tpu.ops.pallas_sweep import toeplitz_sweep_pallas
from origin_tpu.pipeline.engine import _mask_extrema
from origin_tpu_torch.pipeline.session import ORIGIN

torch.set_num_threads(2)

CUT = (slice(100, 260), slice(8, 44), slice(6, 40))


def _steps(orig, seg_fn):
    orig.step01_preprocessing()
    orig.step02_areas(minsize=30, maxsize=60)
    orig.step03_compute_PCA_threshold()
    orig.step04_compute_greedy_PCA()
    orig.step05_compute_TGLR()
    orig.step06_compute_purity_threshold(purity=0.8)
    orig.step07_detection(segmap=seg_fn)
    return orig


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("bf16x3")
    cube_fn, seg_fn = str(path / "minicube.fits"), str(path / "segmap.fits")
    make_minicube(cube_fn)
    make_segmap(seg_fn)
    kw = dict(path=str(path), loglevel="WARNING", device="cpu")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for prec in ("highest", "bf16x3"):
            mp.setenv("ORIGIN_TPU_PRECISION", prec)
            out[prec] = _steps(ORIGIN.init(cube_fn, name=prec, **kw), seg_fn)
    out["cube_fn"] = cube_fn
    yield out
    for prec in ("highest", "bf16x3"):
        out[prec].close_logfile()


def test_minicube_bf16x3_reproduces_the_goldens(runs):
    hi, lo = runs["highest"], runs["bf16x3"]
    assert len(lo.Cat0) == 15
    assert len(lo.Cat1) == 14
    for key in ("threshold", "threshold_std"):
        assert lo.param[key] == pytest.approx(hi.param[key], abs=1e-3)
    # the mode really changed the statistic, by ~1e-5 relative
    diff = np.abs(lo.cube_correl.data - hi.cube_correl.data).max()
    assert 0 < diff < 1e-3


def test_step05_bf16x3_matches_the_jax_chain(runs, tmp_path, monkeypatch):
    from origin_tpu_torch.core import Cube

    faint = np.asarray(runs["bf16x3"].cube_faint.data)[CUT]
    full = Cube(runs["cube_fn"])
    zsl, ysl, xsl = CUT
    cut = Cube(data=full.data[CUT], var=full.var[CUT], wcs=full.wcs[ysl, xsl],
               wave=full.wave[zsl],
               primary_header=full.primary_header)  # the FSF model
    orig = ORIGIN.init(cut, name="cut", path=str(tmp_path),
                       loglevel="WARNING", device="cpu")
    monkeypatch.setenv("ORIGIN_TPU_PRECISION", "bf16x3")
    orig.engine.load_state({"cube_faint": faint})
    dev, host = orig.engine.tglr(orig.PSF, orig.wfields, orig.profiles)
    mask = orig.engine.input_mask().numpy()
    orig.close_logfile()

    nz, ny, nx = faint.shape
    psfs = np.asarray(orig.PSF, np.float32)[None]
    fshape2 = fft2_shape((ny, nx), psfs.shape[-2:])
    kern_hats, norm_fsf = precompute_spatial(jnp.asarray(psfs), None, ny, nx,
                                             fshape2)
    factors = {k: jnp.asarray(v) for k, v in dft_spatial_factors(
        ny, nx, fshape2, psfs.shape[-2:]).items()}
    cube_fsf = glr_spatial_pallas(
        jnp.asarray(faint), jnp.real(kern_hats), jnp.imag(kern_hats), None,
        factors, interpret=True, precision="bf16x3")
    t_num, t_den, pad_left, _ = pack_profiles_toeplitz(
        prepare_profiles(orig.profiles), block=min(128, nz))
    correl, profile, cmin = toeplitz_sweep_pallas(
        cube_fsf, norm_fsf, jnp.asarray(t_num), jnp.asarray(t_den), pad_left,
        nz, interpret=True, precision="bf16x3")
    (correl, _, profile, lmax, _, maxmap, _) = (
        np.asarray(a) for a in _mask_extrema(
            correl, cmin, profile, jnp.asarray(mask), 3, prof_dtype="uint8"))

    np.testing.assert_allclose(dev["cube_correl"].numpy(), correl, rtol=0,
                               atol=5e-5)
    np.testing.assert_allclose(host["maxmap"], maxmap, rtol=0, atol=5e-5)
    np.testing.assert_array_equal(dev["cube_profile"].numpy(), profile)
    np.testing.assert_array_equal(dev["cube_local_max"].numpy() > 0,
                                  lmax > 0)
    assert (lmax > 0).sum() > 100
