"""The tight-memory mode of the torch port against the JAX package's.

A field runs tight when the device's budget cannot hold 24 float32 cubes
of it (``ORIGIN_TPU_HBM_BYTES``, else the CUDA device's total memory, the
CPU without limit).  Held here on the CPU:

- ``device_memory_fits`` and ``TorchEngine.tight_memory`` give the JAX
  package's answers: the environment override flips the mode, a CUDA
  device's reported total (``torch.cuda.mem_get_info``, monkeypatched) is
  honoured without an allocation, the CPU is unlimited, and
  ``memory_shards`` divides the need.
- ``glr_spatial_chunked`` against the JAX function at ``zchunk=16``, for
  one field and a two-field mosaic, at the JAX test's atol 1e-5; and
  against the port's own ``glr_spatial_matmul`` chain at the tolerance of
  the JAX test ``test_glr_spatial_matmul_matches_fft`` (atol 2e-5, rtol
  2e-4).
- Step 08's host cut (inputs dropped, few windows) against the device
  gather, without uploading the field again, and against the JAX
  package's estimation on the same windows (positions exact, values at
  ``tests/lines_cases.hold``'s rtol 1e-4).
- Steps 01-11 of the minicube with ``ORIGIN_TPU_HBM_BYTES=1e6`` against
  the JAX package's tight session (its ``tight_memory`` forced, its power
  iterations run to their whole budget, ``tests/jax_full_budget.py``):
  thresholds within 1e-3, Cat0/Cat1 counts and Cat1 and Cat2 row for row
  at ``tests/test_torch_pipeline.py``'s tolerances, the Cat3 counts, the
  residency after steps 01, 04 and 05, step 11's host path and one source
  file per source, the session files in the compact forms and a ``load``
  that resumes to the same catalogs; the offloaded products keep their
  file bytes and their standard deviation; the tight catalogs equal the
  port's normal-mode ones.
"""

import glob
import os

import numpy as np
import pytest
import torch

from jax_full_budget import jax_full_budget
from lines_cases import hold
from make_minicube import make_minicube, make_segmap
from origin_tpu import ORIGIN as JaxORIGIN
from origin_tpu import fitsio as jfitsio
from origin_tpu.core import MoffatFSF
from origin_tpu.ops import glr as jglr
from origin_tpu.ops import lines as jlines
from origin_tpu.pipeline import engine as jengine
from origin_tpu_torch.ops import glr as tglr
from origin_tpu_torch.ops import lines as tlines
from origin_tpu_torch.ops.convolve import fft2_shape
from origin_tpu_torch.pipeline import engine as tengine
from origin_tpu_torch.pipeline.products import FORMATS, TensorCube
from origin_tpu_torch.pipeline.recipes import LazyRecipeCube
from origin_tpu_torch.pipeline.session import ORIGIN
from origin_tpu_torch.pipeline.steps import SaveSources

torch.set_num_threads(2)

OFFLOADED = {"step01": ("cont_dct",), "step04": ("cube_std",),
             "step05": ("cube_faint", "cube_correl_min")}


class _Shape:
    """The engines read only the field's shape to decide the mode."""

    shape = (100, 50, 50)  # 24 cubes: 24e6 bytes


@pytest.fixture
def no_jax_constants(monkeypatch):
    """The JAX engine counts its cross-session constants, which other
    tests of the process may have uploaded, against the budget: none."""
    monkeypatch.setattr(jengine, "_upload_cache", {})


# -- the decision ---------------------------------------------------------------
@pytest.mark.parametrize("nbytes", [10_000, 999_999, 1_000_000, 2_000_000])
def test_budget_env_matches_jax(monkeypatch, nbytes):
    monkeypatch.setenv("ORIGIN_TPU_HBM_BYTES", "1e6")
    want = jengine.device_memory_fits(nbytes)
    assert tengine.device_memory_fits(nbytes, "cpu") is want
    assert want is (nbytes <= 1_000_000)


@pytest.mark.parametrize("budget,tight", [("1e6", True), ("1e12", False),
                                          ("2.4e7", False), ("2.3e7", True)])
def test_env_override_flips_the_mode(monkeypatch, no_jax_constants, budget,
                                     tight):
    monkeypatch.setenv("ORIGIN_TPU_HBM_BYTES", budget)
    assert jengine.DeviceEngine(_Shape()).tight_memory is tight
    assert tengine.TorchEngine(_Shape(), "cpu").tight_memory is tight


def test_cuda_reported_total_is_honoured(monkeypatch):
    """The CUDA budget is the total ``mem_get_info`` reports (the JAX
    package's ``bytes_limit``); nothing is allocated to find it."""
    monkeypatch.delenv("ORIGIN_TPU_HBM_BYTES", raising=False)
    calls = []

    def mem_get_info(device=None):
        calls.append(device)
        return (1 << 18, 1 << 20)  # (free, total)

    def no_alloc(*args, **kwargs):
        raise AssertionError("the budget was probed by an allocation")

    monkeypatch.setattr(torch.cuda, "mem_get_info", mem_get_info)
    for name in ("empty", "zeros", "ones", "full"):
        monkeypatch.setattr(torch, name, no_alloc)

    class FakeDev:
        platform = "gpu"

        def memory_stats(self):
            return {"bytes_limit": 1 << 20}

    cuda = torch.device("cuda")
    for nbytes in (1 << 19, 1 << 20, 1 << 21):
        want = jengine.device_memory_fits(nbytes, device=FakeDev())
        assert tengine.device_memory_fits(nbytes, cuda) is want
    assert tengine.device_memory_budget(cuda) == (
        1 << 20, "torch.cuda.mem_get_info")
    assert len(calls) == 4 and all(torch.device(d) == cuda for d in calls)


def test_cpu_is_unlimited(monkeypatch):
    monkeypatch.delenv("ORIGIN_TPU_HBM_BYTES", raising=False)
    assert tengine.device_memory_fits(1 << 62, "cpu")
    assert tengine.device_memory_budget("cpu")[0] is None
    assert not tengine.TorchEngine(_Shape(), "cpu").tight_memory


def test_memory_shards_divide_the_need(monkeypatch, no_jax_constants):
    """Four shards need a quarter of the 24 cubes, in both packages."""
    monkeypatch.setenv("ORIGIN_TPU_HBM_BYTES", "1e7")  # need 2.4e7 / 4

    class JaxSharded(jengine.DeviceEngine):
        memory_shards = 4

    class TorchSharded(tengine.TorchEngine):
        memory_shards = 4

    assert tengine.TorchEngine.memory_shards == 1
    assert tengine.TorchEngine.HEADROOM_CUBES == 24
    assert jengine.DeviceEngine(_Shape()).tight_memory
    assert tengine.TorchEngine(_Shape(), "cpu").tight_memory
    assert not JaxSharded(_Shape()).tight_memory
    assert not TorchSharded(_Shape(), "cpu").tight_memory


# -- the chunked spatial stage --------------------------------------------------
def _spatial_case(mosaic):
    rng = np.random.default_rng(9)
    nz, ny, nx = 50, 10, 12
    cube = rng.normal(size=(nz, ny, nx)).astype(np.float32)
    fsf = MoffatFSF(fwhm_pol=[0.2, 0.6], beta_pol=[2.8], pixstep=0.2)
    psf = fsf.get_3darray(np.linspace(5000, 9000, nz),
                          (7, 7)).astype(np.float32)
    fshape2 = fft2_shape((ny, nx), (7, 7))
    if not mosaic:
        return cube, psf[None], None, fshape2
    w1 = np.zeros((ny, nx), np.float32)
    w1[:, :6] = 1
    return cube, np.stack([psf, psf * 1.1]), np.stack([w1, 1 - w1]), fshape2


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("mosaic", [False, True], ids=["field", "mosaic"])
def test_glr_spatial_chunked_matches_jax(mosaic):
    import jax.numpy as jnp

    cube, psfs, wmaps, fshape2 = _spatial_case(mosaic)
    c0, n0 = jglr.glr_spatial_chunked(
        jnp.asarray(cube), jnp.asarray(psfs),
        None if wmaps is None else jnp.asarray(wmaps), fshape2, zchunk=16)
    c1, n1 = tglr.glr_spatial_chunked(_t(cube), _t(psfs), _t(wmaps),
                                      fshape2, zchunk=16)
    np.testing.assert_allclose(c1.numpy(), np.asarray(c0), rtol=0, atol=1e-5)
    np.testing.assert_allclose(n1.numpy(), np.asarray(n0), rtol=0, atol=1e-5)


@pytest.mark.parametrize("mosaic", [False, True], ids=["field", "mosaic"])
def test_glr_spatial_chunked_matches_the_matmul_chain(mosaic):
    cube, psfs, wmaps, fshape2 = _spatial_case(mosaic)
    ny, nx = cube.shape[1:]
    kern_hats, n0 = tglr.precompute_spatial(_t(psfs), _t(wmaps), ny, nx,
                                            fshape2)
    factors = {k: _t(v) for k, v in tglr.dft_spatial_factors(
        ny, nx, fshape2, psfs.shape[-2:]).items()}
    c0 = tglr.glr_spatial_matmul(_t(cube), kern_hats.real.contiguous(),
                                 kern_hats.imag.contiguous(), _t(wmaps),
                                 factors)
    for zchunk in (16, 512):
        c1, n1 = tglr.glr_spatial_chunked(_t(cube), _t(psfs), _t(wmaps),
                                          fshape2, zchunk=zchunk)
        np.testing.assert_allclose(c1.numpy(), c0.numpy(), atol=2e-5,
                                   rtol=2e-4)
        np.testing.assert_allclose(n1.numpy(), n0.numpy(), atol=2e-5,
                                   rtol=2e-4)


# -- the minicube sessions -----------------------------------------------------
def _steps(orig, seg_fn, residency=None, upto=11):
    calls = (
        ("step01", lambda: orig.step01_preprocessing()),
        ("step02", lambda: orig.step02_areas(minsize=30, maxsize=60)),
        ("step03", lambda: orig.step03_compute_PCA_threshold()),
        ("step04", lambda: orig.step04_compute_greedy_PCA()),
        ("step05", lambda: orig.step05_compute_TGLR()),
        ("step06", lambda: orig.step06_compute_purity_threshold(purity=0.8)),
        ("step07", lambda: orig.step07_detection(segmap=seg_fn)),
        ("step08", lambda: orig.step08_compute_spectra()),
        ("step09", lambda: orig.step09_clean_results()),
        ("step10", lambda: orig.step10_create_masks()),
        ("step11", lambda: orig.step11_save_sources("0.1")),
    )
    for name, call in calls[:upto]:
        call()
        if residency is not None and name in OFFLOADED:
            residency[name] = residency_of(orig, OFFLOADED[name])
    return orig


def residency_of(orig, names):
    """Which of ``names`` hold device memory, and whether the raw inputs
    do: the JAX package's DeferredCube.device, the port's engine."""
    eng = orig.engine
    if isinstance(orig, ORIGIN):
        on = {n: eng.on_device(n) for n in names}
    else:
        on = {n: getattr(getattr(orig, n), "device", None) is not None
              for n in names}
    return on, eng.inputs_resident()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("tight")
    cube_fn, seg_fn = str(path / "minicube.fits"), str(path / "segmap.fits")
    make_minicube(cube_fn)
    make_segmap(seg_fn)
    kw = dict(path=str(path), loglevel="WARNING")
    res = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ORIGIN_TPU_CORREL_WIRE", "f32")
        mp.setattr(jengine.DeviceEngine, "tight_memory",
                   property(lambda self: True))
        with jax_full_budget():
            jax_tight = _steps(JaxORIGIN.init(cube_fn, name="jax", **kw),
                               seg_fn, res.setdefault("jax", {}))
    normal = _steps(ORIGIN.init(cube_fn, name="normal", device="cpu", **kw),
                    seg_fn)
    seen = []
    real = SaveSources._device_source_artifacts

    def spy(orig, nb_fwhm):
        seen.append(real(orig, nb_fwhm))
        return seen[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ORIGIN_TPU_HBM_BYTES", "1e6")
        mp.setattr(SaveSources, "_device_source_artifacts",
                   staticmethod(spy))
        tight = _steps(ORIGIN.init(cube_fn, name="tight", device="cpu", **kw),
                       seg_fn, res.setdefault("tight", {}))
    yield dict(jax=jax_tight, normal=normal, tight=tight, residency=res,
               artifacts=seen, seg_fn=seg_fn)
    for o in (jax_tight, normal, tight):
        o.close_logfile()


def _same_rows(a, b, exact, close, rtol):
    assert a.colnames == b.colnames and len(a) == len(b)
    for col in exact:
        np.testing.assert_array_equal(np.asarray(a[col]), np.asarray(b[col]),
                                      err_msg=col)
    for col in close:
        x, y = np.asarray(a[col], float), np.asarray(b[col], float)
        np.testing.assert_array_equal(np.isnan(x), np.isnan(y), err_msg=col)
        np.testing.assert_allclose(x[~np.isnan(x)], y[~np.isnan(y)],
                                   rtol=rtol, err_msg=col)


def _same_catalogs(a, b):
    """Thresholds within 1e-3, Cat0 and Cat1 counts, Cat1 and Cat2 row for
    row, Cat3 (tests/test_torch_pipeline.py's tolerances)."""
    for key in ("threshold", "threshold_std"):
        assert a.param[key] == pytest.approx(b.param[key], abs=1e-3)
    assert len(a.Cat0) == len(b.Cat0)
    _same_rows(a.Cat1, b.Cat1, ("x0", "y0", "z0", "profile", "comp", "ID"),
               ("T_GLR", "STD"), rtol=1e-4)
    _same_rows(a.Cat2, b.Cat2, ("x", "y", "z", "num_line"),
               ("flux", "residual"), rtol=1e-4)
    _same_rows(a.Cat3_lines, b.Cat3_lines, ("ID", "merged_in"),
               ("nsigTGLR", "nsigSTD"), rtol=1e-5)
    _same_rows(a.Cat3_sources, b.Cat3_sources,
               ("ID", "n_lines", "comp", "waves"), ("nsigTGLR", "nsigSTD"),
               rtol=1e-5)


def test_the_minicube_session_is_tight(runs):
    assert runs["tight"].engine.tight_memory
    assert not runs["normal"].engine.tight_memory


def test_tight_session_matches_jax_tight_session(runs):
    t, j = runs["tight"], runs["jax"]
    _same_catalogs(t, j)
    assert (len(t.Cat0), len(t.Cat1)) == (15, 14)
    comp = np.asarray(t.Cat3_sources["comp"])
    assert (len(t.Cat3_lines), len(t.Cat3_sources),
            int(np.sum(comp == 1))) == (14, 13, 2)


@pytest.mark.parametrize("step", sorted(OFFLOADED))
def test_residency_after_the_step_matches_jax(runs, step):
    """After step 01 the raw inputs and cont_dct left the device, after
    step 04 cube_std, after step 05 cube_faint and cube_correl_min."""
    res = runs["residency"]
    assert res["tight"][step] == res["jax"][step]
    on, inputs = res["tight"][step]
    assert not any(on.values()) and not inputs


def test_step11_takes_the_host_path(runs):
    t = runs["tight"]
    assert runs["artifacts"] == [(None, None)]
    assert t.engine.source_spectra({}) == {}
    files = glob.glob(os.path.join(t.outpath, "sources", "source-*.fits"))
    assert len(files) == len(t.Cat3_sources) == 13


def test_tight_write_keeps_the_compact_forms(runs):
    t = runs["tight"]
    for name in ("cube_correl", "cube_correl_min"):
        hdr = jfitsio.getheader(os.path.join(t.outpath, f"{name}.fits"),
                                ext=1)
        assert int(hdr["BITPIX"]) == 16, name
    for name in ("cube_local_max", "cube_local_min", "cube_std_local_max",
                 "cube_std_local_min"):
        assert jfitsio.getheader(os.path.join(t.outpath, f"{name}.fits"))[
            "ORITPUSP"] == "extrema16", name
    for name, kind in (("cube_std", "dct_std"), ("cont_dct", "dct_cont"),
                       ("cube_faint", "pca_faint")):
        assert jfitsio.getheader(os.path.join(t.outpath, f"{name}.fits"))[
            "ORITPURE"] == kind, name


def test_a_loaded_tight_session_resumes_to_the_same_catalogs(runs,
                                                             monkeypatch):
    t = runs["tight"]
    monkeypatch.setenv("ORIGIN_TPU_HBM_BYTES", "1e6")
    c = ORIGIN.load(t.outpath, newname="tight_resumed", device="cpu")
    try:
        assert c.engine.tight_memory
        c.step05_compute_TGLR()
        assert not c.engine.on_device("cube_faint")
        c.step06_compute_purity_threshold(purity=0.8)
        c.step07_detection(segmap=runs["seg_fn"])
        c.step08_compute_spectra()
        c.step09_clean_results()
        _same_catalogs(c, t)
    finally:
        c.close_logfile()


def test_tight_catalogs_equal_the_normal_ones(runs):
    _same_catalogs(runs["tight"], runs["normal"])


# -- offload on a session of its own ---------------------------------------------
@pytest.fixture(scope="module")
def offload_session(tmp_path_factory):
    path = tmp_path_factory.mktemp("offload")
    cube_fn, seg_fn = str(path / "minicube.fits"), str(path / "segmap.fits")
    make_minicube(cube_fn, nz=200, ny=40, nx=40)
    make_segmap(seg_fn)
    orig = ORIGIN.init(cube_fn, name="s", path=str(path), device="cpu",
                       loglevel="WARNING")
    _steps(orig, seg_fn, upto=5)
    yield orig, path
    orig.close_logfile()


@pytest.mark.parametrize("name", ["cont_dct", "cube_std", "cube_faint",
                                  "cube_correl_min", "cube_correl"])
def test_offload_keeps_the_file_bytes_and_std(offload_session, name):
    """An offloaded product is written as the same bytes, holds no device
    tensor and keeps its standard deviation; ``get`` gives it back."""
    orig, path = offload_session
    eng = orig.engine
    before = eng.get(name).clone()
    std = eng.std_scalar(name)
    save = FORMATS["cube"].save
    save(orig._product_owner[name].store.peek(name), str(path / "a.fits"))
    eng.offload(name)
    obj = orig._product_owner[name].store.peek(name)
    assert not eng.on_device(name)
    assert isinstance(obj, LazyRecipeCube) == (
        name in ("cont_dct", "cube_std", "cube_faint"))
    assert eng.std_scalar(name) == std
    save(obj, str(path / "b.fits"))
    with open(path / "a.fits", "rb") as fa, open(path / "b.fits", "rb") as fb:
        assert fa.read() == fb.read()
    got = eng.get(name)
    if isinstance(obj, TensorCube):
        torch.testing.assert_close(got, before, rtol=0, atol=0)
    else:  # the host rebuild: float32 summation order
        torch.testing.assert_close(got, before, rtol=0, atol=1e-4)


# -- step 08's host cut ------------------------------------------------------
@pytest.fixture(scope="module")
def lines_session(tmp_path_factory):
    path = tmp_path_factory.mktemp("lines")
    fn = str(path / "m.fits")
    make_minicube(fn, nz=120, ny=48, nx=52)
    orig = ORIGIN.init(fn, name="s", path=str(path), device="cpu",
                       loglevel="ERROR")
    yield orig
    orig.close_logfile()


def _line_inputs(orig, mosaic):
    x0, y0, z0 = np.array([10, 40, 25]), np.array([12, 30, 40]), \
        np.array([40, 60, 80])
    if not mosaic:
        return (x0, y0, z0), orig.PSF, None
    w1 = np.zeros(orig.shape[1:], np.float32)
    w1[:, :26] = 1
    return (x0, y0, z0), [orig.PSF, orig.PSF * 1.1], [w1, 1 - w1]


@pytest.mark.parametrize("mosaic", [False, True], ids=["field", "mosaic"])
def test_step08_host_cut_matches_the_device_gather(lines_session, mosaic):
    orig = lines_session
    eng = orig.engine
    xyz, psf, weights = _line_inputs(orig, mosaic)
    eng.input_cube()
    ref = tlines.estimation_line_arrays(*xyz, None, None, psf,
                                        weights=weights, engine=eng, batch=2)
    eng.drop_inputs("cube", "var", "mask")
    assert not eng.inputs_resident()
    calls = []
    real = eng._ensure_inputs
    eng._ensure_inputs = lambda *n: calls.append(n) or real(*n)
    try:
        # 3 lines x 625 window px < 48 x 52 field px: the host cut
        got = tlines.estimation_line_arrays(*xyz, None, None, psf,
                                            weights=weights, engine=eng,
                                            batch=2)
    finally:
        del eng._ensure_inputs
    assert not calls and not eng.inputs_resident(), "the field was uploaded"
    hold(got, ref, rtol=1e-6)
    if not mosaic:
        with jax_full_budget():
            want = jlines.estimation_line_arrays(*xyz, orig.cube_raw,
                                                 orig.var, psf, batch=2)
        hold(got, want, rtol=1e-4)


def test_step08_many_windows_upload_the_field_and_drop_it(lines_session,
                                                          monkeypatch):
    """Where the windows hold as many spaxels as the field, a tight engine
    uploads the inputs for the gather and drops them after it."""
    orig = lines_session
    eng = orig.engine
    rng = np.random.default_rng(5)
    n = 5  # 5 x 625 >= 48 x 52
    xyz = (rng.integers(0, 52, n), rng.integers(0, 48, n),
           rng.integers(10, 110, n))
    eng.input_cube()
    ref = tlines.estimation_line_arrays(*xyz, None, None, orig.PSF,
                                        engine=eng)
    eng.drop_inputs("cube", "var")
    monkeypatch.setattr(eng, "_tight", True)
    got = tlines.estimation_line_arrays(*xyz, None, None, orig.PSF,
                                        engine=eng)
    assert not eng.inputs_resident()
    hold(got, ref, rtol=0)
