"""The system's two configurations beyond the default, port against JAX.

Both packages run on the CPU, the JAX package with its power iterations
run to their whole budget (tests/jax_full_budget.py) and with
``ORIGIN_TPU_CORREL_WIRE=f32``, as in tests/test_torch_pipeline.py, whose
tolerances hold here: thresholds within 1e-3, Cat0/Cat1 row for row
(x0, y0, z0, profile, comp, ID exact; T_GLR and STD at rtol 1e-4), Cat2
(x, y, z, num_line exact; flux and residual at rtol 1e-4), the spectra
within 1e-4 of their largest magnitude, Cat3 (integers equal, nsig* at
rtol 1e-5), the masks exactly and the source files by
``assert_same_source_files``.

- Config 2, the 20-profile dictionary ``Dico_FWHM_2_12`` on
  ``make_minicube(nz=300, ny=40, nx=40)`` with the arguments of
  tests/test_pipeline.py's ``test_pipeline_20_profile_dictionary``
  (areas 20/40, purity 0.8), steps 01-11.
- Config 4, the two-field mosaic of tests/test_mosaic.py (one Moffat FSF
  per field in the header, the field map's left and right halves,
  ``PSF_size=13``), steps 01-11.  The JAX package's step 11 stops there:
  ``read_fsf_from_header`` gives it a list of models, which it reads as
  one.  The port gives each source its own FSF, the fields' FWHM and beta
  polynomials averaged with the fields' weights at the source
  (``core/fsf.py:combine_fsf``; field 99 of its source file).  So the
  port's files are held to the JAX step 11 run with the JAX package's
  ``read_fsf_from_header`` swapped, for that run, for one that returns
  this model; the JAX package is not changed.
- The bf16x3 route of the mosaic's step 05 (the spatial stage weighted
  over the two fields, then the bf16x3 sweep; plain versions on the CPU)
  against the JAX chain of that mode in interpret mode, at
  tests/test_torch_bf16x3.py's tolerance, 5e-5.
"""

import os

import numpy as np
import pytest
import torch

from jax_full_budget import jax_full_budget
from make_minicube import make_minicube
from origin_tpu import ORIGIN as JaxORIGIN
from origin_tpu.core import Image as JImage
from origin_tpu.core import MoffatFSF as JMoffatFSF
from origin_tpu_torch.core import DICO_FWHM_2_12
from origin_tpu_torch.core.fsf import (
    MoffatFSF,
    SOURCE_FIELD,
    combine_fsf,
    field_weights,
    read_fsf_from_header,
)
from origin_tpu_torch.pipeline.session import ORIGIN
from origin_tpu_torch.pipeline.steps import SaveSources
from test_torch_pipeline import (
    _assert_same_table,
    _listing,
    _sources,
    assert_same_source_files,
)

torch.set_num_threads(2)

K20_STEPS = dict(step02=dict(minsize=20, maxsize=40))


def _run(orig, step02=None, upto=11):
    orig.step01_preprocessing()
    orig.step02_areas(**(step02 or {}))
    orig.step03_compute_PCA_threshold()
    orig.step04_compute_greedy_PCA()
    orig.step05_compute_TGLR()
    orig.step06_compute_purity_threshold(purity=0.8)
    orig.step07_detection()
    orig.step08_compute_spectra()
    orig.step09_clean_results()
    orig.step10_create_masks()
    if upto == 11:
        orig.step11_save_sources("0.1")
    return orig


@pytest.fixture(scope="module")
def k20(tmp_path_factory):
    path = tmp_path_factory.mktemp("k20")
    cube_fn = str(path / "m.fits")
    make_minicube(cube_fn, nz=300, ny=40, nx=40)
    kw = dict(path=str(path), loglevel="WARNING")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ORIGIN_TPU_CORREL_WIRE", "f32")
        with jax_full_budget():
            jax = _run(JaxORIGIN.init(cube_fn, name="jax",
                                      profiles=DICO_FWHM_2_12, **kw),
                       K20_STEPS["step02"])
    port = _run(ORIGIN.init(cube_fn, name="port", profiles=DICO_FWHM_2_12,
                            device="cpu", **kw), K20_STEPS["step02"])
    yield jax, port
    for o in (jax, port):
        o.close_logfile()


# -- config 2: the 20-profile dictionary --------------------------------------
def test_k20_dictionary_and_thresholds(k20):
    j, t = k20
    assert len(t.profiles) == len(j.profiles) == 20
    np.testing.assert_array_equal(t.FWHM_profiles, j.FWHM_profiles)
    for a, b in zip(t.profiles, j.profiles):
        np.testing.assert_array_equal(a, b)
    for key in ("threshold", "threshold_std"):
        assert t.param[key] == pytest.approx(j.param[key], abs=1e-3)


def test_k20_cat0_cat1_row_for_row(k20):
    j, t = k20
    assert len(t.Cat1) > 0
    for name in ("Cat0", "Cat1"):
        assert len(getattr(t, name)) == len(getattr(j, name))
        _assert_same_lines(getattr(t, name), getattr(j, name))
    prof = np.asarray(t.Cat1["profile"])
    assert prof.max() < 20 and len(np.unique(prof)) > 3
    assert t.cube_profile.data.dtype == np.uint8
    assert int(t.cube_profile.data.max()) < 20


def test_k20_cat2_cat3_and_spectra(k20):
    j, t = k20
    assert len(t.Cat2) == len(j.Cat2)
    _assert_same_table(t.Cat2, j.Cat2, ("x", "y", "z", "num_line"),
                       ("flux", "residual"), rtol=1e-4)
    _assert_same_spectra(t.spectra, j.spectra)
    _assert_same_table(t.Cat3_lines, j.Cat3_lines, ("ID", "merged_in"),
                       ("nsigTGLR", "nsigSTD"), rtol=1e-5)
    _assert_same_table(t.Cat3_sources, j.Cat3_sources,
                       ("ID", "n_lines", "comp", "waves"),
                       ("nsigTGLR", "nsigSTD"), rtol=1e-5)


def test_k20_masks_and_source_files(k20):
    j, t = k20
    _assert_same_masks(t, j)
    ours, ref = _sources(t), _sources(j)
    assert len(ours) == len(t.Cat3_sources) > 0
    assert_same_source_files(ours, ref, count=len(ref))
    for src in ours.values():
        assert os.path.basename(src.header["OR_PROF"]) == DICO_FWHM_2_12


def _assert_same_lines(a, b):
    """Cat0 or Cat1 row for row: positions, profile, comp and (Cat1) ID
    exact, T_GLR and STD at rtol 1e-4."""
    assert a.colnames == b.colnames
    exact = [c for c in ("x0", "y0", "z0", "profile", "comp", "ID")
             if c in b.colnames]
    _assert_same_table(a, b, exact, (), rtol=0)
    for col in ("T_GLR", "STD"):
        x, y = np.asarray(a[col], float), np.asarray(b[col], float)
        np.testing.assert_array_equal(np.isnan(x), np.isnan(y))
        np.testing.assert_allclose(x[~np.isnan(x)], y[~np.isnan(y)],
                                   rtol=1e-4)


def _assert_same_spectra(ours, ref):
    assert list(ours) == list(ref)
    for num, sp in ours.items():
        want = np.asarray(ref[num].data, float)
        assert sp.shape == ref[num].shape
        np.testing.assert_allclose(sp.data, want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def _assert_same_masks(t, j):
    from origin_tpu_torch.core import Image

    folder = os.path.join(t.outpath, "masks")
    names = _listing(folder)
    assert names == _listing(os.path.join(j.outpath, "masks"))
    assert len(names) == 2 * len(t.Cat3_sources)
    for name in names:
        a = Image(os.path.join(folder, name))
        b = Image(os.path.join(j.outpath, "masks", name))
        np.testing.assert_array_equal(a.data, b.data, err_msg=name)
        assert tuple(a.wcs.crpix) == tuple(b.wcs.crpix), name


# -- config 4: one FSF per field, weighted by a field map ----------------------
FIELDS = ((0.7, 2.8), (0.6, 2.6))  # (FWHM, beta) of each field's FSF


@pytest.fixture(scope="module")
def mosaic(tmp_path_factory):
    path = tmp_path_factory.mktemp("mosaic")
    cube_fn, fmap_fn = str(path / "mosaic.fits"), str(path / "fieldmap.fits")
    cube = make_minicube(nz=200, ny=40, nx=40)
    hdr = cube.primary_header
    for key in list(hdr.keys()):
        if key.startswith("FSF") and key not in ("FSFMODE", "FSFLB1",
                                                 "FSFLB2"):
            del hdr[key]
    for field, (fwhm, beta) in enumerate(FIELDS):
        JMoffatFSF(fwhm_pol=[fwhm], beta_pol=[beta], field=field).to_header(
            hdr)
    cube.write(cube_fn)
    fmap = np.zeros((40, 40), dtype=np.int64)
    fmap[:, :20] = 1
    fmap[:, 20:] = 2
    JImage(data=fmap).write(fmap_fn)
    kw = dict(path=str(path), loglevel="WARNING", fieldmap=fmap_fn,
              PSF_size=13)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ORIGIN_TPU_CORREL_WIRE", "f32")
        with jax_full_budget():
            jax = _run(JaxORIGIN.init(cube_fn, name="jax", **kw), upto=10)
    port = _run(ORIGIN.init(cube_fn, name="port", device="cpu", **kw))
    out = dict(jax=jax, port=port, path=path, cube_fn=cube_fn)
    yield out
    for o in (jax, port):
        o.close_logfile()


def test_mosaic_fsf_and_weights(mosaic):
    j, t = mosaic["jax"], mosaic["port"]
    assert isinstance(t.PSF, list) and len(t.PSF) == len(j.PSF) == 2
    for a, b in zip(t.PSF, j.PSF):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert t.wfields is not None and len(t.wfields) == 2
    for a, b in zip(t.wfields, j.wfields):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(t.FWHM_PSF),
                                  np.asarray(j.FWHM_PSF))
    np.testing.assert_array_equal(t.LBDA_FWHM_PSF, j.LBDA_FWHM_PSF)


def test_mosaic_correl_and_thresholds(mosaic):
    j, t = mosaic["jax"], mosaic["port"]
    np.testing.assert_array_equal(t.mapO2.data, np.asarray(j.mapO2.data))
    np.testing.assert_allclose(t.cube_correl.data,
                               np.asarray(j.cube_correl.data), rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(t.cube_profile.data,
                                  np.asarray(j.cube_profile.data))
    for key in ("threshold", "threshold_std"):
        assert t.param[key] == pytest.approx(j.param[key], abs=1e-3)


def test_mosaic_catalogs(mosaic):
    j, t = mosaic["jax"], mosaic["port"]
    assert len(t.Cat1) > 0
    for name in ("Cat0", "Cat1"):
        assert len(getattr(t, name)) == len(getattr(j, name))
        _assert_same_lines(getattr(t, name), getattr(j, name))
    _assert_same_table(t.Cat2, j.Cat2, ("x", "y", "z", "num_line"),
                       ("flux", "residual"), rtol=1e-4)
    _assert_same_table(t.Cat3_lines, j.Cat3_lines, ("ID", "merged_in"),
                       ("nsigTGLR", "nsigSTD"), rtol=1e-5)
    _assert_same_table(t.Cat3_sources, j.Cat3_sources,
                       ("ID", "n_lines", "comp", "waves"),
                       ("nsigTGLR", "nsigSTD"), rtol=1e-5)
    _assert_same_masks(t, j)


def test_mosaic_step08_spectra_with_the_weights(mosaic):
    """Step 08 weighs the two fields' PSFs per pixel: its spectra equal the
    JAX package's, and differ from a run that ignores the weights."""
    from origin_tpu_torch.ops.lines import estimation_line_arrays

    j, t = mosaic["jax"], mosaic["port"]
    _assert_same_spectra(t.spectra, j.spectra)
    pos = [np.asarray(t.Cat1[c], int) for c in ("x0", "y0", "z0")]
    one = estimation_line_arrays(*pos, t.cube_raw, t.var, t.PSF[0],
                                 device="cpu")
    both = estimation_line_arrays(*pos, t.cube_raw, t.var, t.PSF,
                                  weights=t.wfields, device="cpu")
    np.testing.assert_array_equal(both["flux"],
                                  np.asarray(t.Cat2["flux"], np.float32))
    assert not np.array_equal(one["flux"], both["flux"])


def _swapped_fsf(monkeypatch, model):
    """The JAX package's step 11, for the duration, reads ``model`` (the
    port's FSF of a source) wherever it reads the cube header's FSF."""
    import origin_tpu.artifacts.source as jsource
    import origin_tpu.core.fsf as jfsf

    def read(hdr, pixstep=0.2):
        return JMoffatFSF(model.fwhm_pol, model.beta_pol,
                          lbrange=model.lbrange, pixstep=pixstep)

    for mod in (jfsf, jsource):  # step 11 imports it from core.fsf
        monkeypatch.setattr(mod, "read_fsf_from_header", read)


def test_mosaic_jax_step11_reads_one_field(mosaic, tmp_path):
    """The JAX package's step 11 cannot run a two-field header."""
    with pytest.raises(AttributeError, match="get_fwhm"):
        mosaic["jax"].step11_save_sources("0.1", path=str(tmp_path))


def test_mosaic_source_files(mosaic, tmp_path, monkeypatch):
    """Each port source file against the JAX step 11 run with that
    source's FSF; the file records both fields' models and its own."""
    j, t = mosaic["jax"], mosaic["port"]
    ours = _sources(t)
    assert len(ours) == len(t.Cat3_sources) > 0
    hdr = t.cube.primary_header
    step = float(t.wcs.get_step(unit="arcsec")[0])
    models = read_fsf_from_header(hdr, pixstep=step)
    by_model = {}
    for row in t.Cat3_sources:
        w = tuple(field_weights(t.wfields, row["y"], row["x"]))
        assert sorted(w) == [0.0, 1.0]  # the halves do not overlap
        by_model.setdefault(w, []).append("source-%05d.fits" % row["ID"])
    own = ["FSF%02d%s" % (SOURCE_FIELD, k)
           for k in ("FNC", "F00", "BNC", "B00")]
    for w, names in by_model.items():
        model = combine_fsf(models, w)
        field = w.index(1.0)
        assert model.fwhm_pol == [FIELDS[field][0]]
        assert model.beta_pol == [FIELDS[field][1]]
        out = tmp_path / ("field%d" % field)
        out.mkdir()
        with monkeypatch.context() as mp:
            mp.setenv("ORIGIN_TPU_CORREL_WIRE", "f32")
            _swapped_fsf(mp, model)
            j.step11_save_sources("0.1", path=str(out))
        ref = _sources(j, str(out / j.name / "sources"))
        assert_same_source_files({n: ours[n] for n in names},
                                 {n: ref[n] for n in names}, skip_keys=own,
                                 count=len(names))
        for name in names:
            src = ours[name]
            for ff in range(len(FIELDS)):
                assert src.header["FSF%02dF00" % ff] == FIELDS[ff][0]
                assert src.header["FSF%02dB00" % ff] == FIELDS[ff][1]
            got = src.get_FSF()
            assert (got.fwhm_pol, got.beta_pol) == (model.fwhm_pol,
                                                    model.beta_pol)


def test_mosaic_device_rounds_match_the_host_path(mosaic, tmp_path,
                                                  monkeypatch):
    """Step 11's batched spectra, grouped by size and per-source FSF, give
    the files of the host path, which reads each source's FSF from its
    file."""
    t = mosaic["port"]
    seen = {}
    real = SaveSources._device_source_artifacts

    def spy(o, nb_fwhm):
        seen["out"] = real(o, nb_fwhm)
        return seen["out"]

    for kind in ("device", "host"):
        (tmp_path / kind).mkdir()
        monkeypatch.setattr(SaveSources, "_device_source_artifacts",
                            staticmethod(spy if kind == "device"
                                         else lambda o, nb: (None, None)))
        t.step11_save_sources("0.1", path=str(tmp_path / kind))
    assert seen["out"][0], "the batched device spectra did not run"
    dev, host = (_sources(t, str(tmp_path / kind / t.name / "sources"))
                 for kind in ("device", "host"))
    assert list(dev) == list(host) and len(dev) == len(t.Cat3_sources)
    for name, a in dev.items():
        b = host[name]
        assert set(a.spectra) == set(b.spectra)
        for tag in a.spectra:
            scale = max(1.0, float(np.nanmax(np.abs(b.spectra[tag].data))))
            np.testing.assert_allclose(
                np.asarray(a.spectra[tag].data),
                np.asarray(b.spectra[tag].data), atol=2e-3 * scale,
                err_msg=f"{name} {tag}")


def test_mosaic_update_sources_matches_step11(mosaic, tmp_path):
    """``update_sources`` given the session's weight maps rewrites step
    11's files, the source's own FSF included; without them it raises."""
    from origin_tpu_torch.artifacts.source_update import update_sources

    t = mosaic["port"]
    ids = [int(i) for i in t.Cat3_sources["ID"]]

    def fn(name):
        return os.path.join(t.outpath, name + ".fits")

    args = (ids, t.Cat3_sources, t.Cat3_lines, t.param, fn("cube_correl"),
            fn("cube_std"), t.param["mask_filename_tpl"],
            t.param["skymask_filename_tpl"], fn("spectra"),
            {"LABEL": t.segmap_label, "MERGED": t.segmap_merged}, "0.1",
            t.FWHM_profiles, str(tmp_path / "source-%0.5d.fits"))
    with pytest.raises(ValueError, match="field weights"):
        update_sources(*args)
    update_sources(*args, wfields=t.wfields)
    assert_same_source_files(_sources(t, str(tmp_path)), _sources(t),
                             count=len(ids))


def test_mosaic_write_and_load_keep_the_fields(mosaic):
    """Step 11's closing write, loaded by the port and by the JAX package,
    keeps the PSF list and the weight maps."""
    t = mosaic["port"]
    for cls, kw in ((ORIGIN, dict(device="cpu")), (JaxORIGIN, {})):
        loaded = cls.load(t.outpath, **kw)
        try:
            assert isinstance(loaded.PSF, list) and len(loaded.PSF) == 2
            for a, b in zip(loaded.PSF, t.PSF):
                np.testing.assert_array_equal(np.asarray(a), b)
            assert loaded.wfields is not None and len(loaded.wfields) == 2
            for a, b in zip(loaded.wfields, t.wfields):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
            np.testing.assert_array_equal(np.asarray(loaded.FWHM_PSF),
                                          np.asarray(t.FWHM_PSF))
            assert len(loaded.Cat3_sources) == len(t.Cat3_sources)
        finally:
            loaded.close_logfile()


def test_combine_fsf_weights_the_polynomials():
    """The combined model's FWHM and beta are the weighted means of the
    fields' at every wavelength, polynomials of different degrees
    included; weights summing to 0 count the fields equally."""
    a = MoffatFSF([-0.2, 0.7], [2.8], field=0)
    b = MoffatFSF([0.1, -0.3, 0.6], [0.2, 2.5], field=1)
    lbda = np.linspace(4750.0, 9350.0, 7)
    for w in ((0.25, 0.75), (1.0, 0.0), (0.0, 0.0)):
        got = combine_fsf([a, b], w)
        wn = np.asarray(w) / sum(w) if sum(w) else np.array([0.5, 0.5])
        for attr in ("get_fwhm", "get_beta"):
            want = sum(x * getattr(m, attr)(lbda) for x, m in zip(wn, (a, b)))
            np.testing.assert_allclose(getattr(got, attr)(lbda), want,
                                       rtol=1e-12)
        assert got.field == SOURCE_FIELD
    wmaps = [np.eye(3), 1 - np.eye(3)]
    assert field_weights(wmaps, 1.4, 0.6) == [1.0, 0.0]
    assert field_weights(wmaps, -2.0, 7.0) == [0.0, 1.0]  # clipped


# -- the mosaic's bf16x3 step 05 -----------------------------------------------
def test_mosaic_step05_bf16x3_matches_the_jax_chain(mosaic, monkeypatch):
    import jax.numpy as jnp

    from origin_tpu.ops.convolve import fft2_shape
    from origin_tpu.ops.glr import (
        dft_spatial_factors,
        pack_profiles_toeplitz,
        precompute_spatial,
        prepare_profiles,
    )
    from origin_tpu.ops.pallas_spatial import glr_spatial_pallas
    from origin_tpu.ops.pallas_sweep import toeplitz_sweep_pallas
    from origin_tpu.pipeline.engine import _mask_extrema

    t = mosaic["port"]
    monkeypatch.setenv("ORIGIN_TPU_PRECISION", "bf16x3")
    dev, host = t.engine.tglr(t.PSF, t.wfields, t.profiles)
    faint = t.engine.get("cube_faint").numpy()
    mask = t.engine.input_mask().numpy()

    nz, ny, nx = faint.shape
    psfs = jnp.asarray(np.stack([np.asarray(p, np.float32) for p in t.PSF]))
    wmaps = jnp.asarray(np.stack([np.asarray(w, np.float32)
                                  for w in t.wfields]))
    fshape2 = fft2_shape((ny, nx), psfs.shape[-2:])
    kern_hats, norm_fsf = precompute_spatial(psfs, wmaps, ny, nx, fshape2)
    factors = {k: jnp.asarray(v) for k, v in dft_spatial_factors(
        ny, nx, fshape2, psfs.shape[-2:]).items()}
    cube_fsf = glr_spatial_pallas(
        jnp.asarray(faint), jnp.real(kern_hats), jnp.imag(kern_hats), wmaps,
        factors, interpret=True, precision="bf16x3")
    t_num, t_den, pad_left, _ = pack_profiles_toeplitz(
        prepare_profiles(t.profiles), block=min(128, nz))
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
    # the mode changed the statistic, and the two fields' weights matter
    assert 0 < np.abs(dev["cube_correl"].numpy()
                      - t.cube_correl.data).max() < 1e-3
