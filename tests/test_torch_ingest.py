"""The streamed ingest of the torch port against the JAX package's.

- ``fitsio.scan`` gives the JAX package's headers, payload offsets and
  byte counts, on the minicube and on a file with a BINTABLE HDU.
- ``IngestPlan.read`` gives the JAX ``IngestPlan.read``'s cube and the
  port's eager ``Cube(fn)`` exactly (data, variance, mask, coordinates),
  and hands the same float32 slabs to its callbacks, whose concatenation
  is the eager cube: over slab sizes (one slab, 10**6 bytes, one plane),
  with and without STAT, BITPIX -32 and -64, with and without NaN voxels.
- ``IngestPlan.scan`` refuses (None) each layout the JAX package refuses.
- On ``device="cpu"`` a streamed session's device inputs are the eager
  route's bit for bit, and a streamed minicube session gives the goldens.
- ``run ... --overlap-ingest --device cpu`` gives the JAX CLI's catalogs,
  and each session's log holds only its own records.
- The staged route's white image (the reduction of the staged float32
  slabs), streamed and eager, on files with no non-finite value, NaN
  voxels, infinities, an all-NaN spaxel and a NaN border: the host
  ``cube.mean(axis=0)``'s mask bit for bit, data within 2 float32 ulp of
  the float64 mean of the finite values; the host cube's mask
  ``~isfinite`` bit for bit; the ``ingest.white`` span's ``route`` and the
  ``ingest.flagged_spaxels`` counter.  A float64 payload, an in-memory
  ``Cube``, a loaded session and a mesh session keep the host mean.

The CUDA route (pinned staging on a copy stream) is held in
tests/test_torch_gpu.py, which imports no JAX.
"""

import os
import re
import shutil
from collections import OrderedDict

import numpy as np
import pytest
import torch

from torch.profiler import ProfilerActivity, profile

import ingest_cases
import origin_tpu.fitsio as jfitsio
import origin_tpu.pipeline.ingest as jingest
from jax_full_budget import jax_full_budget
from make_minicube import make_minicube, make_segmap
from origin_tpu.__main__ import main as jax_main
from origin_tpu.core import Table as JTable
from origin_tpu_torch import fitsio, tracing
from origin_tpu_torch.__main__ import main
from origin_tpu_torch.core import Table
from origin_tpu_torch.core.containers import Cube
from origin_tpu_torch.parallel.mesh import make_mesh
from origin_tpu_torch.pipeline import engine as engine_mod
from origin_tpu_torch.pipeline import ingest
from origin_tpu_torch.pipeline.session import ORIGIN

torch.set_num_threads(2)

# the JAX package's goldens with the power iteration's whole budget
# (tests/test_torch_pipeline.py, ROADMAP.md section 3)
FULL_BUDGET = dict(threshold=4.564202, threshold_std=4.866594, cat0=15,
                   cat1=14)
SLABS = {"one_slab": 10 ** 12, "1e6_bytes": 10 ** 6, "one_plane": 1}


@pytest.fixture(scope="module")
def minicube(tmp_path_factory):
    fn = str(tmp_path_factory.mktemp("ingest") / "minicube.fits")
    make_minicube(fn)
    return fn


def _variant(src, dst, bitpix=-32, stat=True, nan=True):
    """``src`` rewritten: DATA (and STAT) as ``bitpix`` floats, STAT
    dropped, or the NaN voxels set finite (data 0, variance 1)."""
    hdus = fitsio.read(src)
    out = [hdus[0]]
    for h in hdus[1:]:
        if h.name == "STAT" and not stat:
            continue
        data = h.data
        if not nan:
            data = np.where(np.isfinite(data), data, 1.0 if h.name == "STAT"
                            else 0.0)
        data = data.astype(np.float32 if bitpix == -32 else np.float64)
        out.append(fitsio.HDU(data=data, header=h.header))
    fitsio.write(dst, out)
    return dst


def _same_header(a, b):
    assert list(a.items()) == list(b.items())
    assert list(a.history) == list(b.history)
    assert list(a.comments_raw) == list(b.comments_raw)


@pytest.mark.parametrize("kind", ["minicube", "bintable"])
def test_scan_matches_jax(minicube, tmp_path, kind):
    fn = minicube
    if kind == "bintable":
        fn = str(tmp_path / "table.fits")
        cols = OrderedDict(ID=np.arange(7, dtype=np.int32),
                           FLUX=np.linspace(0, 1, 7),
                           NAME=np.array([f"s{i}" for i in range(7)]))
        img = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
        fitsio.write(fn, [fitsio.HDU(), fitsio.HDU(data=cols, name="CAT"),
                          fitsio.HDU(data=img, name="DATA")])
    got, want = fitsio.scan(fn), jfitsio.scan(fn)
    assert len(got) == len(want) == 3
    for (gh, go, gn), (wh, wo, wn) in zip(got, want):
        _same_header(gh, wh)
        assert (go, gn) == (wo, wn)
    if kind == "bintable":
        assert str(got[1][0]["XTENSION"]).strip() == "BINTABLE"
        assert got[1][2] > 0 and got[0][2] == 0
        with open(fn, "rb") as fh:  # the offsets point at the payloads
            fh.seek(got[-1][1])
            raw = np.frombuffer(fh.read(got[-1][2]), ">f4")
        np.testing.assert_array_equal(raw.reshape(img.shape), img)


@pytest.mark.parametrize("nan", [True, False], ids=["nan", "finite"])
@pytest.mark.parametrize("bitpix", [-32, -64])
@pytest.mark.parametrize("stat", [True, False], ids=["stat", "no_stat"])
@pytest.mark.parametrize("slab", list(SLABS))
def test_read_matches_jax_and_eager(minicube, tmp_path, monkeypatch, slab,
                                    stat, bitpix, nan):
    """The port of tests/test_engine.py's test_stream_ingest_matches_eager,
    held to the JAX reader too."""
    fn = _variant(minicube, str(tmp_path / "v.fits"), bitpix, stat, nan)
    monkeypatch.setattr(ingest, "_SLAB_BYTES", SLABS[slab])
    monkeypatch.setattr(jingest, "_SLAB_BYTES", SLABS[slab])
    plan, jplan = ingest.IngestPlan.scan(fn), jingest.IngestPlan.scan(fn)
    assert plan is not None and jplan is not None
    assert plan.has_var == stat
    got = {"data": [], "var": []}
    jgot = {"data": [], "var": []}
    cube = plan.read(got["data"].append, got["var"].append)
    jcube = jplan.read(jgot["data"].append, jgot["var"].append)
    eager = Cube(fn)
    assert plan.shape == jplan.shape == eager.shape == cube.shape
    for c in (jcube, eager):
        assert np.asarray(c.data).dtype == cube.data.dtype
        np.testing.assert_array_equal(cube.data, np.asarray(c.data))
        if stat:
            np.testing.assert_array_equal(cube.var, np.asarray(c.var))
        else:
            assert cube.var is None and c.var is None
        if nan:
            np.testing.assert_array_equal(cube.mask, np.asarray(c.mask))
        else:
            assert cube.mask is None and c.mask is None
        np.testing.assert_array_equal(cube.masked_invalid(),
                                      np.asarray(c.masked_invalid()))
        np.testing.assert_allclose(cube.wave.coord(), c.wave.coord(),
                                   rtol=0)
        np.testing.assert_allclose(cube.wcs.cd, c.wcs.cd, rtol=0)
    # served from the stamp, with no scan of the data
    assert cube._mask_is_nonfinite
    if nan:
        assert cube.masked_invalid() is cube.mask
    _same_header(cube.data_header, eager.data_header)
    _same_header(cube.primary_header, eager.primary_header)
    nz = plan.shape[0]
    per_slab = {"one_slab": nz, "one_plane": 1,
                "1e6_bytes": 10 ** 6 // (60 * 60 * -bitpix // 8)}[slab]
    for kind, want in (("data", eager.data), ("var", eager.var)):
        slabs = got[kind]
        assert len(slabs) == len(jgot[kind])
        if want is None:
            assert not slabs
            continue
        assert len(slabs) == -(-nz // per_slab)
        for a, b in zip(slabs, jgot[kind]):
            assert a.dtype == np.float32
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.concatenate(slabs),
                                      np.asarray(want, np.float32))


def _write_refused(path, case):
    """A file of the layout ``case``, which the streamed reader refuses."""
    rng = np.random.default_rng(3)
    cube = rng.normal(size=(6, 5, 4)).astype(np.float32)
    hdr = fitsio.Header()
    hdus = [fitsio.HDU()]
    if case == "image_2d":
        hdus.append(fitsio.HDU(data=cube[0], name="DATA"))
    elif case == "bscale":
        hdr["BSCALE"] = 2.0
        hdus.append(fitsio.HDU(data=cube, header=hdr, name="DATA"))
    elif case == "integer":
        hdus.append(fitsio.HDU(data=(cube * 100).astype(np.int16),
                               name="DATA"))
    elif case == "two_data_cubes":
        hdus += [fitsio.HDU(data=cube, name="DATA"),
                 fitsio.HDU(data=cube, name="OTHER")]
    elif case == "stat_shape":
        hdus += [fitsio.HDU(data=cube, name="DATA"),
                 fitsio.HDU(data=cube[:, :4], name="STAT")]
    elif case == "not_fits":
        with open(path, "wb") as fh:
            fh.write(b"not a FITS file")
        return path
    fitsio.write(path, hdus)
    return path


@pytest.mark.parametrize("case,jax_none", [
    ("image_2d", True), ("bscale", True), ("integer", True),
    ("two_data_cubes", True), ("stat_shape", True), ("not_fits", True),
    ("knob_off", True), ("streamable", False),
])
def test_scan_refuses_what_jax_refuses(minicube, tmp_path, monkeypatch,
                                       case, jax_none):
    if case in ("knob_off", "streamable"):
        fn = minicube
        if case == "knob_off":
            monkeypatch.setenv("ORIGIN_TPU_STREAM_INGEST", "0")
    else:
        fn = _write_refused(str(tmp_path / f"{case}.fits"), case)
    assert (jingest.IngestPlan.scan(fn) is None) == jax_none
    assert (ingest.IngestPlan.scan(fn) is None) == jax_none


def test_truncated_payload_raises(minicube, tmp_path):
    fn = str(tmp_path / "cut.fits")
    with open(minicube, "rb") as src, open(fn, "wb") as dst:
        dst.write(src.read(os.path.getsize(minicube) // 2))
    plan = ingest.IngestPlan.scan(fn)
    assert plan is not None  # the headers it needs come first
    with pytest.raises(OSError, match="truncated"):
        plan.read()
    with pytest.raises(OSError, match="truncated"):
        jingest.IngestPlan.scan(fn).read()


def _reader(orig):
    """Which reader the session's init took, from its log file (whose
    first ingest line is its own: sessions open together share the
    logger)."""
    with open(orig.logfile) as fh:
        lines = [ln for ln in fh if " ingest: " in ln]
    return "streamed" if "ingest: streamed" in lines[0] else "eager"


def _inputs(orig):
    eng = orig.engine
    return eng.input_cube(), eng.input_var(), eng.input_mask()


@pytest.mark.parametrize("nan", [True, False], ids=["nan", "finite"])
@pytest.mark.parametrize("bitpix", [-32, -64])
@pytest.mark.parametrize("stat", [True, False], ids=["stat", "no_stat"])
def test_streamed_inputs_equal_the_eager_routes(tmp_path, monkeypatch, stat,
                                                bitpix, nan):
    """The streamed session's device inputs equal, bit for bit, the eager
    read's with its copies started at init and with the upload at step 01
    (where a cube with NaN voxels uploads its host views).  The one
    difference, shared with the JAX package's two routes: without STAT the
    host view of the variance is 1 at a masked voxel, where the derived
    one is inf."""
    src = str(tmp_path / "src.fits")
    make_minicube(src, nz=120, ny=24, nx=20)
    fn = _variant(src, str(tmp_path / "v.fits"), bitpix, stat, nan)
    monkeypatch.setattr(ingest, "_SLAB_BYTES", 10 ** 5)
    kw = dict(device="cpu", path=str(tmp_path), loglevel="WARNING")
    streamed = ORIGIN.init(fn, name="streamed", **kw)
    monkeypatch.setenv("ORIGIN_TPU_STREAM_INGEST", "0")
    eager = ORIGIN.init(fn, name="eager", **kw)
    step01 = ORIGIN.init(fn, name="step01", **kw)
    assert _reader(streamed) == "streamed" and _reader(eager) == "eager"
    assert streamed.engine._staged is not None
    assert eager.engine._staged is not None
    step01.engine.release()  # drops the started copies: upload at step 01
    assert step01.engine._staged is None
    got = _inputs(streamed)
    assert streamed.engine._staged is None  # joined once
    for t in got:
        assert t.device.type == "cpu" and t.shape == (120, 24, 20)
    assert got[0].dtype == got[1].dtype == torch.float32
    assert bool(got[2].any()) == nan
    for other in (eager, step01):
        for a, b, name in zip(got, _inputs(other), ("cube", "var", "mask")):
            if other is step01 and name == "var" and nan and not stat:
                m = got[2]
                assert torch.equal(a[~m], b[~m])
                assert bool(torch.isinf(a[m]).all()) and bool(
                    (b[m] == 1).all())
                continue
            assert torch.equal(a, b), (other.name, name)
    np.testing.assert_array_equal(streamed.cube.data, eager.cube.data)
    for o in (streamed, eager, step01):
        o.close_logfile()


def test_ring_copies_a_slab_larger_than_its_buffers():
    """A slab of more values than a ring buffer is copied a buffer at a
    time, float64 cast as numpy casts it; a slab of the wrong size
    raises."""
    ring = engine_mod._SlabRing(4 * 7, pinned=False)
    rng = np.random.default_rng(5)
    src = rng.normal(size=(5, 3, 4))
    dst = torch.full((9, 3, 4), -1.0)
    ring.copy(dst[2:7], src, None)
    want = torch.from_numpy(src.astype(np.float32))
    assert torch.equal(dst[2:7], want)
    assert bool((dst[:2] == -1).all()) and bool((dst[7:] == -1).all())
    assert ring.slot == -(-src.size // 7) % ring.SLOTS
    with pytest.raises(ValueError, match="slab"):
        ring.copy(dst[0:2], src, None)


def test_staged_inputs_join_checks_every_plane():
    """The join hands over complete inputs only, once."""
    staged = engine_mod._StagedInputs(torch.device("cpu"), (4, 2, 3), True)
    slab = np.arange(24, dtype=np.float32).reshape(4, 2, 3)
    staged.put("data", slab[:3])
    staged.put("var", slab)
    with pytest.raises(RuntimeError, match="3 of 4"):
        staged.join()
    staged.put("data", slab[3:])
    raw = staged.join()
    assert torch.equal(raw["data"], torch.from_numpy(slab))
    assert torch.equal(raw["var"], torch.from_numpy(slab))
    assert staged.raw == {}


def test_nonstreamable_file_prefetches(tmp_path):
    """A layout the streamed reader refuses (a scaled int16 cube) is read
    eagerly, its copies start at init, and its inputs are the upload at
    step 01's."""
    src = str(tmp_path / "src.fits")
    make_minicube(src, nz=60, ny=24, nx=20)
    hdus = fitsio.read(src)
    for h in hdus[1:]:
        q = np.where(np.isfinite(h.data), h.data, 0.0) * 100
        h.data = np.clip(np.round(q), -32000, 32000).astype(np.int16)
        h.header["BSCALE"] = 0.01
    fn = str(tmp_path / "int16.fits")
    fitsio.write(fn, hdus)
    assert ingest.IngestPlan.scan(fn) is None
    kw = dict(device="cpu", path=str(tmp_path), loglevel="WARNING")
    a = ORIGIN.init(fn, name="a", **kw)
    b = ORIGIN.init(fn, name="b", **kw)
    assert _reader(a) == "eager" and a.engine._staged is not None
    b.engine.release()
    for x, y in zip(_inputs(a), _inputs(b)):
        assert torch.equal(x, y)
    for o in (a, b):
        o.close_logfile()


def test_in_memory_and_loaded_sessions_stage_nothing(minicube, tmp_path):
    kw = dict(device="cpu", path=str(tmp_path), loglevel="WARNING")
    orig = ORIGIN.init(Cube(minicube), name="mem", **kw)
    assert orig.engine._staged is None
    orig.step01_preprocessing()
    orig.write()
    orig.close_logfile()
    loaded = ORIGIN.load(orig.outpath, device="cpu")
    assert loaded.engine._staged is None
    loaded.close_logfile()


def _traced(make):
    """The session ``make()`` returns, made under a CPU profile, with its
    ``ingest.white`` span's route and the ``ingest.flagged_spaxels``
    counts it recorded."""
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        orig = make()
    spans, counts = tracing.records()
    tracing.clear()
    (white,) = [s for s in spans if s.name == "ingest.white"]
    flagged = [c.n for c in counts if c.name == "ingest.flagged_spaxels"]
    return orig, white.attrs["route"], flagged


@pytest.mark.parametrize("route", ["streamed", "eager"])
@pytest.mark.parametrize("pattern", ingest_cases.PATTERNS)
def test_staged_white_matches_the_host_mean(tmp_path, monkeypatch, pattern,
                                            route):
    """A float32 file staged at init, streamed in several slabs or put
    whole after the eager read, takes the staged route: its white image
    is the host mean's, and its host cube the eager read's.  The ring's
    buffers are cut so that the reduction runs in several pieces: along z
    (streamed) and across the spaxels too (eager)."""
    fn = ingest_cases.write_pattern(str(tmp_path / "p.fits"), pattern)
    ring = {"streamed": 10 ** 5, "eager": 8000}[route]
    monkeypatch.setattr(ingest, "_SLAB_BYTES", ring)
    monkeypatch.setattr(engine_mod, "_RINGS", {})
    if route == "eager":
        monkeypatch.setenv("ORIGIN_TPU_STREAM_INGEST", "0")
    orig, got, flagged = _traced(lambda: ORIGIN.init(
        fn, name=route, device="cpu", path=str(tmp_path),
        loglevel="WARNING"))
    assert _reader(orig) == route and got == "staged"
    data = Cube(fn).data
    ingest_cases.check_white(orig.ima_white, orig.cube.mean(axis=0), data)
    ingest_cases.check_cube_mask(orig.cube, data)
    np.testing.assert_array_equal(orig.cube.data, data)
    # the streamed read builds its mask from the counts; the eager one
    # scanned the cube in Cube(fn)
    want = [ingest_cases.flagged_spaxels(data)]
    assert flagged == (want if route == "streamed" else [])
    orig.close_logfile()


@pytest.mark.parametrize("case", ["float64", "in_memory", "loaded", "mesh"])
def test_host_routes_keep_the_host_mean(tmp_path, case):
    """Where nothing staged float32 data at init, the white image is the
    host ``Cube.mean(axis=0)`` of today, exactly."""
    bitpix = -64 if case == "float64" else -32
    fn = ingest_cases.write_pattern(str(tmp_path / "p.fits"), "nan_spaxel",
                                    bitpix=bitpix)
    kw = dict(device="cpu", path=str(tmp_path), loglevel="WARNING")
    want = Cube(fn).mean(axis=0)
    if case == "loaded":
        first = ORIGIN.init(Cube(fn), name="first", **kw)
        first.step01_preprocessing()
        first.write()
        first.close_logfile()

        def make():
            return ORIGIN.load(first.outpath, device="cpu")
    else:
        cube = Cube(fn) if case == "in_memory" else fn
        mesh = make_mesh(devices=["cpu"] * 2) if case == "mesh" else None

        def make():
            return ORIGIN.init(cube, name=case, mesh=mesh, **kw)
    orig, route, flagged = _traced(make)
    assert route == "host" and flagged == []
    assert orig.ima_white.data.dtype == want.data.dtype
    np.testing.assert_array_equal(orig.ima_white.data, want.data)
    np.testing.assert_array_equal(orig.ima_white.mask, want.mask)
    orig.close_logfile()


def test_streamed_minicube_session_gives_the_goldens(minicube, tmp_path,
                                                     monkeypatch):
    seg = str(tmp_path / "seg.fits")
    make_segmap(seg)
    monkeypatch.setattr(ingest, "_SLAB_BYTES", 10 ** 6)
    orig = ORIGIN.init(minicube, name="s", device="cpu", path=str(tmp_path),
                       loglevel="WARNING")
    assert _reader(orig) == "streamed"
    orig.step01_preprocessing()
    orig.step02_areas(minsize=30, maxsize=60)
    orig.step03_compute_PCA_threshold()
    orig.step04_compute_greedy_PCA()
    orig.step05_compute_TGLR()
    orig.step06_compute_purity_threshold(purity=0.8)
    orig.step07_detection(segmap=seg)
    for key in ("threshold", "threshold_std"):
        assert orig.param[key] == pytest.approx(FULL_BUDGET[key], abs=1e-3)
    assert len(orig.Cat0) == FULL_BUDGET["cat0"]
    assert len(orig.Cat1) == FULL_BUDGET["cat1"]
    orig.close_logfile()


RUN = ["--purity", "0.8", "--minsize", "20", "--no-sources",
       "--loglevel", "WARNING"]


def _rows(folder, table=Table):
    cat = table.read(os.path.join(folder, "Cat1.fits"))
    cols = ("x0", "y0", "z0", "profile", "comp", "ID")
    return np.stack([np.asarray(cat[c], np.int64) for c in cols], axis=1)


def _log_holds_only_its_own(folder, cube_fn, others):
    """The session's log names only its own cube and holds each step's
    record once."""
    name = os.path.basename(folder)
    with open(os.path.join(folder, name + ".log")) as fh:
        text = fh.read()
    assert f"Read the Data Cube {cube_fn}\n" in text
    for other in others:
        assert f"Read the Data Cube {other}\n" not in text, other
    starts = re.findall(r" Step (\d\d) - ", text)
    assert starts == [f"{i:02d}" for i in range(10)], starts
    assert "ingest: streamed" in text


@pytest.mark.parametrize("order", ["bad_middle", "two_fields"])
def test_cli_overlap_ingest_matches_jax(tmp_path, capsys, order):
    """The port of tests/test_cli.py's test_cli_survey_overlap_ingest, held
    to the JAX CLI's ``--overlap-ingest`` run (its power iteration run to
    its whole budget); with two good fields the second is initialized
    while the first is current."""
    cube_fn = str(tmp_path / "minicube.fits")
    make_minicube(cube_fn, nz=300, ny=40, nx=40)
    second = str(tmp_path / "field2.fits")
    shutil.copy(cube_fn, second)
    cubes = [cube_fn, second]
    if order == "bad_middle":
        bad = str(tmp_path / "bad.fits")
        with open(bad, "wb") as fh:
            fh.write(b"not a FITS file")
        cubes.insert(1, bad)
    argv = ["run", *cubes, "--path", str(tmp_path), *RUN, "--overlap-ingest"]
    rc = main([*argv, "--name", "ovl", "--device", "cpu"])
    err = capsys.readouterr().err
    if order == "bad_middle":
        assert rc == 1 and "survey: 1 cube(s) failed: " + bad in err
    else:
        assert rc == 0 and "survey:" not in err
    with jax_full_budget():
        assert jax_main([*argv, "--name", "jax"]) == rc
    cats = []
    for stem, fn in (("minicube", cube_fn), ("field2", second)):
        folder = str(tmp_path / f"ovl-{stem}")
        rows = _rows(folder)
        np.testing.assert_array_equal(
            rows, _rows(str(tmp_path / f"jax-{stem}"), JTable))
        cats.append(rows)
        _log_holds_only_its_own(folder, fn, set(cubes) - {fn})
    np.testing.assert_array_equal(cats[0], cats[1])
    assert len(cats[0]) > 0
