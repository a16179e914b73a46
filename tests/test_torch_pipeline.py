"""The slice: steps 01-07 of the torch port against the JAX package.

Both packages run the synthetic minicube (tests/make_minicube.py) through
steps 01-07 on the CPU with the golden parameters of tests/test_pipeline.py
(areas 30/60, purity 0.8, the test segmap).

- Steps 01-03 agree to float32 summation order: cube_std at atol 1e-4
  (values up to ~25; the batched GLS sums in another order) and so its
  mean image ima_std, the O2
  thresholds at rtol 1e-5, the area map and segmentations exactly.
- Steps 05-07 fed with the JAX package's cube_faint (through
  origin_tpu_torch.convert) reproduce the JAX goldens: thresholds within
  1e-3, Cat0 15, Cat1 14, and Cat1 row for row (x0, y0, z0, profile, comp,
  ID exact; T_GLR and STD at rtol 1e-4).  cube_correl at atol 1e-3 (the
  statistic divides by sqrt(norm) ~ 0.1 and reaches ~14), the profile
  cube exactly, minmap at atol 1e-5.
- The full torch slice reproduces the goldens' counts, Cat0 15 and Cat1
  14, and every injected line.  Its step 04 runs the power iteration's
  whole budget; the JAX package stops it on a float32 test that rounding
  decides (ROADMAP.md section 3), which moves the goldens' correl
  threshold.  So the torch slice is held row for row to the JAX package
  run with the same budget (tests/jax_full_budget.py): mapO2 exact and
  cube_faint at atol 1e-4, thresholds within 1e-3, Cat1 as above.
"""

import numpy as np
import pytest
import torch

from jax_full_budget import jax_full_budget
from make_minicube import BRIGHT_LINES, FAINT_LINES, make_minicube, make_segmap
from origin_tpu import ORIGIN as JaxORIGIN
from origin_tpu_torch.pipeline.session import ORIGIN

torch.set_num_threads(2)


def _front_steps(orig, seg_fn, upto=7):
    orig.step01_preprocessing()
    orig.step02_areas(minsize=30, maxsize=60)
    orig.step03_compute_PCA_threshold()
    if upto == 3:
        return orig
    orig.step04_compute_greedy_PCA()
    _back_steps(orig, seg_fn)
    return orig


def _back_steps(orig, seg_fn):
    orig.step05_compute_TGLR()
    orig.step06_compute_purity_threshold(purity=0.8)
    orig.step07_detection(segmap=seg_fn)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("slice")
    cube_fn, seg_fn = str(path / "minicube.fits"), str(path / "segmap.fits")
    make_minicube(cube_fn)
    make_segmap(seg_fn)
    kw = dict(path=str(path), loglevel="WARNING")
    jax_run = _front_steps(JaxORIGIN.init(cube_fn, name="jax", **kw), seg_fn)
    with jax_full_budget():
        jax_full = _front_steps(JaxORIGIN.init(cube_fn, name="jax_full", **kw),
                                seg_fn)
    torch_run = _front_steps(
        ORIGIN.init(cube_fn, name="torch", device="cpu", **kw), seg_fn)
    fed = _front_steps(ORIGIN.init(cube_fn, name="fed", device="cpu", **kw),
                       seg_fn, upto=3)
    fed.engine.load_state({"cube_faint": np.asarray(jax_run.cube_faint.data)})
    _back_steps(fed, seg_fn)
    yield jax_run, torch_run, fed, jax_full
    for o in (jax_run, torch_run, fed, jax_full):
        o.close_logfile()


def _assert_same_cat1(a, b):
    assert a.colnames == b.colnames
    for col in ("x0", "y0", "z0", "profile", "comp", "ID"):
        np.testing.assert_array_equal(np.asarray(a[col]), np.asarray(b[col]))
    for col in ("T_GLR", "STD"):
        x, y = np.asarray(a[col], float), np.asarray(b[col], float)
        np.testing.assert_array_equal(np.isnan(x), np.isnan(y))
        np.testing.assert_allclose(x[~np.isnan(x)], y[~np.isnan(y)],
                                   rtol=1e-4)


def test_steps_01_to_03_match_jax(runs):
    j, t, _, _ = runs
    np.testing.assert_allclose(t.cube_std.data, np.asarray(j.cube_std.data),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(t.ima_std.data, j.ima_std.data, rtol=0,
                               atol=1e-4)
    for name in ("segmap_cont", "segmap_merged", "areamap"):
        np.testing.assert_array_equal(getattr(t, name).data,
                                      getattr(j, name).data)
    np.testing.assert_allclose(t.thresO2, j.thresO2, rtol=1e-5)
    for a, b in zip(t.testO2, j.testO2):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_steps_05_to_07_from_jax_faint_reproduce_goldens(runs):
    j, _, fed, _ = runs
    assert j.param["threshold"] == pytest.approx(4.5908, abs=0.02)
    assert fed.param["threshold"] == pytest.approx(j.param["threshold"],
                                                   abs=1e-3)
    assert fed.param["threshold_std"] == pytest.approx(
        j.param["threshold_std"], abs=1e-3)
    assert fed.param["threshold_std"] == pytest.approx(4.8666, abs=0.02)
    assert len(fed.Cat0) == len(j.Cat0) == 15
    assert len(fed.Cat1) == len(j.Cat1) == 14
    _assert_same_cat1(fed.Cat1, j.Cat1)


def test_step05_from_jax_faint_matches_correl_profile_minmap(runs):
    j, _, fed, _ = runs
    np.testing.assert_allclose(fed.cube_correl.data,
                               np.asarray(j.cube_correl.data), rtol=0,
                               atol=1e-3)
    assert fed.cube_profile.data.dtype == np.uint8
    np.testing.assert_array_equal(fed.cube_profile.data,
                                  np.asarray(j.cube_profile.data))
    np.testing.assert_allclose(fed.minmap.data, j.minmap.data, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(fed.maxmap.data, j.maxmap.data, rtol=0,
                               atol=1e-3)


def test_step04_matches_jax_full_budget(runs):
    _, t, _, jf = runs
    np.testing.assert_array_equal(t.mapO2.data, np.asarray(jf.mapO2.data))
    np.testing.assert_allclose(t.cube_faint.data,
                               np.asarray(jf.cube_faint.data), rtol=0,
                               atol=1e-4)


def test_full_torch_slice(runs):
    j, t, _, jf = runs
    assert len(t.Cat0) == len(j.Cat0) == 15
    assert len(t.Cat1) == len(j.Cat1) == 14
    for key in ("threshold", "threshold_std"):
        assert t.param[key] == pytest.approx(jf.param[key], abs=1e-3)
    assert t.param["threshold_std"] == pytest.approx(
        j.param["threshold_std"], abs=1e-3)
    assert len(t.Cat0) == len(jf.Cat0)
    _assert_same_cat1(t.Cat1, jf.Cat1)
    cat = t.Cat1
    x0, y0, z0 = (np.asarray(cat[c]) for c in ("x0", "y0", "z0"))
    for (x, y, z, _, _) in FAINT_LINES + BRIGHT_LINES:
        near = ((np.abs(x0 - x) <= 2) & (np.abs(y0 - y) <= 2)
                & (np.abs(z0 - z) <= 4))
        assert near.any(), f"injected line at ({x},{y},{z}) not recovered"
