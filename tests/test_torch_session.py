"""Session write, load and fork of the torch port, against itself and
against the JAX package.

The minicube (tests/make_minicube.py) runs on the CPU with the golden
parameters of tests/test_pipeline.py; the JAX side as in
tests/test_torch_pipeline.py (its power iterations run to their whole
budget, ``ORIGIN_TPU_CORREL_WIRE=f32``), and with its compact stores off
(``ORIGIN_TPU_STORE_RECIPES``, ``_SPARSE`` and ``_INT16`` set to 0), so
that both packages write the same dense session files.

- Port to port: a session written after step 04 and forked resumes steps
  05-07 to the uninterrupted run's Cat1; one written after step 07
  resumes steps 08-11 to its Cat2, spectra and Cat3 (tables exact) and
  to its 26 mask and 13 source files byte for byte, the timestamp cards
  left out.
- Port to JAX: the port's step-07 session loads in the JAX package with
  the port's thresholds, Cat1, areamap, cube_faint and cube_profile
  (uint8), and the JAX package resumes steps 08-09 from it to the port's
  Cat2 (positions exact, flux and residual at rtol 1e-4) and Cat3.
- JAX to port: the JAX package's step-07 session loads in the port, which
  resumes steps 08-11 to the JAX package's own Cat2, Cat3 and files, to
  the tolerances of tests/test_torch_pipeline.py.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from jax_full_budget import jax_full_budget
from make_minicube import make_minicube, make_segmap
from origin_tpu import ORIGIN as JaxORIGIN
from origin_tpu_torch.pipeline.params import _sanitize, dump_params
from origin_tpu_torch.pipeline.products import Parked, TensorCube
from origin_tpu_torch.pipeline.session import ORIGIN
from origin_tpu_torch.pipeline.steps import Status
from test_torch_pipeline import (
    _assert_same_cat1, _assert_same_table, _listing, _sources,
    assert_same_source_files,
)

torch.set_num_threads(2)

STORE_KNOBS = ("ORIGIN_TPU_STORE_RECIPES", "ORIGIN_TPU_STORE_SPARSE",
               "ORIGIN_TPU_STORE_INT16")
CUBE_PRODUCTS = ("cube_std", "cont_dct", "cube_std_local_min",
                 "cube_std_local_max", "cube_faint", "cube_correl",
                 "cube_correl_min", "cube_profile", "cube_local_min",
                 "cube_local_max")


def _front(orig, seg_fn, steps=range(1, 8)):
    calls = {
        1: lambda: orig.step01_preprocessing(),
        2: lambda: orig.step02_areas(minsize=30, maxsize=60),
        3: lambda: orig.step03_compute_PCA_threshold(),
        4: lambda: orig.step04_compute_greedy_PCA(),
        5: lambda: orig.step05_compute_TGLR(),
        6: lambda: orig.step06_compute_purity_threshold(purity=0.8),
        7: lambda: orig.step07_detection(segmap=seg_fn),
        8: lambda: orig.step08_compute_spectra(),
        9: lambda: orig.step09_clean_results(),
        10: lambda: orig.step10_create_masks(),
        11: lambda: orig.step11_save_sources("0.1"),
    }
    for i in steps:
        calls[i]()
    return orig


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("session")
    cube_fn, seg_fn = str(path / "minicube.fits"), str(path / "segmap.fits")
    make_minicube(cube_fn)
    make_segmap(seg_fn)
    folder = str(path)
    kw = dict(path=folder, loglevel="WARNING")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for knob in STORE_KNOBS:
            mp.setenv(knob, "0")
        mp.setenv("ORIGIN_TPU_CORREL_WIRE", "f32")
        # the port: never stopped (its step 11 writes the session), and
        # written after step 04 (forked there) and after step 07
        out["full"] = _front(ORIGIN.init(cube_fn, name="full", device="cpu",
                                         **kw), seg_fn, range(1, 12))
        port = _front(ORIGIN.init(cube_fn, name="port", device="cpu", **kw),
                      seg_fn, range(1, 5))
        port.write()
        out["p4"] = ORIGIN.load(os.path.join(folder, "port"), newname="p4",
                                device="cpu")
        _front(port, seg_fn, range(5, 8))
        port.write()
        out["port"] = port
        out["p7"] = ORIGIN.load(os.path.join(folder, "port"), newname="p7",
                                device="cpu")
        with jax_full_budget():
            out["jax_from_port"] = JaxORIGIN.load(
                os.path.join(folder, "port"), newname="jax_from_port")
            _front(out["jax_from_port"], seg_fn, (8, 9))
            jax = _front(JaxORIGIN.init(cube_fn, name="jax", **kw), seg_fn)
            jax.write()
            out["port_from_jax"] = ORIGIN.load(
                os.path.join(folder, "jax"), newname="port_from_jax",
                device="cpu")
            out["jax"] = _front(jax, seg_fn, range(8, 12))
        _front(out["p7"], seg_fn, range(8, 12))
        _front(out["p4"], seg_fn, range(5, 8))
        _front(out["port_from_jax"], seg_fn, range(8, 12))
    yield out
    for o in out.values():
        o.close_logfile()


# -- port to port -------------------------------------------------------------
def test_resume_after_step04_gives_the_same_cat1(runs):
    full, p4 = runs["full"], runs["p4"]
    assert [s.status for s in p4.steps.values()][:7] == (
        [Status.DUMPED] * 4 + [Status.RUN] * 3)
    for key in ("threshold", "threshold_std"):
        assert p4.param[key] == full.param[key]
    for name in ("Cat0", "Cat1"):
        _assert_tables_equal(getattr(p4, name), getattr(full, name))
    # step 05 ran on the cube_faint read back from the session file, on
    # the session's device
    assert isinstance(p4.steps["compute_greedy_PCA"].store.peek("cube_faint"),
                      TensorCube)


def _assert_tables_equal(a, b):
    assert a.colnames == b.colnames and len(a) == len(b)
    for col in a.colnames:
        np.testing.assert_array_equal(np.asarray(a[col]), np.asarray(b[col]),
                                      err_msg=col)


def test_resume_after_step07_gives_the_same_catalogs(runs):
    full, p7 = runs["full"], runs["p7"]
    for name in ("Cat1", "Cat2", "Cat3_lines", "Cat3_sources"):
        _assert_tables_equal(getattr(p7, name), getattr(full, name))
    assert list(p7.spectra) == list(full.spectra)
    for num, sp in full.spectra.items():
        np.testing.assert_array_equal(p7.spectra[num].data, sp.data)
        np.testing.assert_array_equal(p7.spectra[num].var, sp.var)
        np.testing.assert_array_equal(p7.spectra[num].wave.coord(),
                                      sp.wave.coord())


def _blank_timestamps(path):
    """The file's bytes without its timestamp cards and its OR_FSF card: a
    loaded session reads its FSF from the session's cube_psf.fits, and
    OR_FSF then names that file instead of the cube header's FSF mode (the
    JAX package does the same)."""
    with open(path, "rb") as fh:
        raw = fh.read()
    cards = [raw[i:i + 80] for i in range(0, len(raw), 80)]
    return b"".join(c for c in cards if not c.startswith(
        (b"SRC_TS  ", b"CAT3_TS ", b"HISTORY ", b"OR_FSF  ", b"CONTINUE")))


def test_resume_after_step07_writes_the_same_files(runs):
    full, p7 = runs["full"], runs["p7"]
    for sub, count in (("masks", 26), ("sources", 13)):
        a, b = (os.path.join(o.outpath, sub) for o in (p7, full))
        assert _listing(a) == _listing(b) and len(_listing(a)) == count
        for name in _listing(a):
            assert _blank_timestamps(os.path.join(a, name)) == \
                _blank_timestamps(os.path.join(b, name)), name


def test_step11_ends_in_the_session_write(runs):
    """Step 11's closing write parks every product: a cube product comes
    back on the session's device at its first fetch, and the loaded
    session shows every step as dumped."""
    full = runs["full"]
    assert all(s.status is Status.DUMPED for s in full.steps.values()
               if s.products)
    store = full.steps["compute_TGLR"].store
    assert isinstance(store.peek("cube_profile"), Parked)
    prof = full.cube_profile
    assert isinstance(prof, TensorCube) and prof.tensor.dtype == torch.uint8
    for name in CUBE_PRODUCTS:
        assert os.path.isfile(os.path.join(full.outpath, name + ".fits"))
    again = ORIGIN.load(full.outpath, device="cpu")
    try:
        assert again.steps["save_sources"].status is Status.DUMPED
        assert again.steps["save_sources"].meta["runtime"] > 0
        _assert_tables_equal(again.Cat3_sources, full.Cat3_sources)
        assert again.Cat3_sources.meta["CAT3_TS"] == \
            full.Cat3_sources.meta["CAT3_TS"]
        assert again.Cat2._formats == full.Cat2._formats
        assert again.Cat2._formats["flux"] == ".1f"
    finally:
        again.close_logfile()


# -- port to JAX --------------------------------------------------------------
def test_port_session_loads_in_jax(runs):
    port, j = runs["port"], runs["jax_from_port"]
    for key in ("threshold", "threshold_std", "nbareas"):
        assert j.param[key] == port.param[key]
    _assert_tables_equal(j.Cat1, port.Cat1)
    np.testing.assert_array_equal(j.areamap.data, port.areamap.data)
    np.testing.assert_array_equal(np.asarray(j.cube_faint.data),
                                  port.cube_faint.data)
    jprof = np.asarray(j.cube_profile.data)
    assert jprof.dtype == port.cube_profile.data.dtype == np.uint8
    np.testing.assert_array_equal(jprof, port.cube_profile.data)


def test_jax_resumes_a_port_session(runs):
    full, j = runs["full"], runs["jax_from_port"]
    assert len(j.Cat2) == len(full.Cat2) == 14
    _assert_same_table(j.Cat2, full.Cat2, ("x", "y", "z", "num_line"),
                       ("flux", "residual"), rtol=1e-4)
    _assert_same_table(j.Cat3_lines, full.Cat3_lines, ("ID", "merged_in"),
                       ("nsigTGLR", "nsigSTD"), rtol=1e-5)
    _assert_same_table(j.Cat3_sources, full.Cat3_sources,
                       ("ID", "n_lines", "comp", "waves"),
                       ("nsigTGLR", "nsigSTD"), rtol=1e-5)


# -- JAX to port --------------------------------------------------------------
def test_jax_session_loads_in_the_port(runs):
    pj, jax = runs["port_from_jax"], runs["jax"]
    for key in ("threshold", "threshold_std"):
        assert pj.param[key] == jax.param[key]
    prof = pj.steps["compute_TGLR"].store
    assert isinstance(prof.peek("cube_profile"), Parked)
    _assert_same_cat1(pj.Cat1, jax.Cat1)
    assert pj.cube_profile.tensor.dtype == torch.uint8
    np.testing.assert_array_equal(pj.cube_profile.data,
                                  np.asarray(jax.cube_profile.data))


def test_port_resumes_a_jax_session(runs):
    pj, jax = runs["port_from_jax"], runs["jax"]
    assert len(pj.Cat2) == len(jax.Cat2) == 14
    _assert_same_table(pj.Cat2, jax.Cat2, ("x", "y", "z", "num_line"),
                       ("flux", "residual"), rtol=1e-4)
    _assert_same_table(pj.Cat3_lines, jax.Cat3_lines, ("ID", "merged_in"),
                       ("nsigTGLR", "nsigSTD"), rtol=1e-5)
    _assert_same_table(pj.Cat3_sources, jax.Cat3_sources,
                       ("ID", "n_lines", "comp", "waves"),
                       ("nsigTGLR", "nsigSTD"), rtol=1e-5)
    masks = [os.path.join(o.outpath, "masks") for o in (pj, jax)]
    assert _listing(masks[0]) == _listing(masks[1])
    for name in _listing(masks[0]):
        a, b = (_blank_timestamps(os.path.join(m, name)) for m in masks)
        assert a == b, name
    # OR_FSF: the loaded session's FSF is its cube_psf.fits (see
    # _blank_timestamps)
    assert_same_source_files(_sources(pj), _sources(jax),
                             skip_keys=("OR_FSF",))


# -- fork, move, erase --------------------------------------------------------
def _snapshot(folder):
    return {n: (os.path.getsize(os.path.join(folder, n)),
                os.path.getmtime(os.path.join(folder, n)))
            for n in _listing(folder)}


def test_fork_move_and_erase(tmp_path):
    cube_fn = str(tmp_path / "tiny.fits")
    make_minicube(cube_fn, nz=120, ny=20, nx=24)
    orig = ORIGIN.init(cube_fn, name="orig", path=str(tmp_path),
                       loglevel="WARNING", device="cpu")
    orig.step01_preprocessing()
    orig.step02_areas()
    orig.step03_compute_PCA_threshold()
    orig.write()
    folder = str(tmp_path / "orig")
    assert (tmp_path / "orig" / "orig.yaml").exists()
    mtimes = {f: os.path.getmtime(os.path.join(folder, f))
              for f in ("cube_psf.fits", "ima_white.fits", "testO2_1.txt")}
    orig.write()  # nothing recomputed: the instrument files are untouched
    for f, t in mtimes.items():
        assert os.path.getmtime(os.path.join(folder, f)) == t, f

    if not torch.cuda.is_available():
        # the device is explicit: no GPU, no fork and no fallback
        with pytest.raises(RuntimeError, match="cuda"):
            ORIGIN.load(folder, newname="gpu")
        assert not (tmp_path / "gpu").exists()

    # the fork runs and writes in its own folder only (the sessions share
    # their logger, so the original's log file is closed first)
    orig.close_logfile()
    before = _snapshot(folder)
    fork = ORIGIN.load(folder, newname="fork", device="cpu")
    assert fork.outpath == str(tmp_path / "fork")
    fork.step04_compute_greedy_PCA()
    fork.write()
    assert _snapshot(folder) == before
    assert (tmp_path / "fork" / "cube_faint.fits").exists()
    assert not (tmp_path / "orig" / "cube_faint.fits").exists()
    np.testing.assert_array_equal(fork.cube_std.data, orig.cube_std.data)

    # a second write rewrites only what was replaced since its fetch: the
    # cube uploaded at its fetch and the untouched image stay as they are
    fork_dir = str(tmp_path / "fork")
    stamps = {n: os.path.getmtime(os.path.join(fork_dir, n + ".fits"))
              for n in ("cube_std", "ima_dct", "ima_std")}
    fork.ima_dct  # fetched, unchanged
    fork.ima_std.data = fork.ima_std.data * 2
    fork.write()
    now = {n: os.path.getmtime(os.path.join(fork_dir, n + ".fits"))
           for n in stamps}
    assert now["cube_std"] == stamps["cube_std"]
    assert now["ima_dct"] == stamps["ima_dct"]
    assert now["ima_std"] > stamps["ima_std"]
    reread = ORIGIN.load(fork_dir, newname="reread", device="cpu")
    np.testing.assert_array_equal(reread.ima_std.data,
                                  orig.ima_std.data * 2)
    reread.close_logfile()
    fork.ima_std.data = orig.ima_std.data

    # write(path=...) moves the session there; erase=True erases the
    # folder first (and its log handler is reopened)
    newpath = tmp_path / "new"
    os.makedirs(newpath)
    fork.write(path=str(newpath), erase=True)
    assert fork.outpath == str(newpath / "fork")
    fork.logger.warning("after the erase")
    moved = ORIGIN.load(str(newpath / "fork"), device="cpu")
    assert (newpath / "fork" / "fork.yaml").exists()
    assert (newpath / "fork" / "fork.log").exists()
    assert moved.steps["compute_greedy_PCA"].status is Status.DUMPED
    np.testing.assert_array_equal(moved.cube_faint.data, fork.cube_faint.data)
    # an erase in place keeps the parked products too
    moved.write(erase=True)
    again = ORIGIN.load(str(newpath / "fork"), device="cpu")
    np.testing.assert_array_equal(again.cube_std.data, orig.cube_std.data)
    np.testing.assert_array_equal(again.thresO2, orig.thresO2)
    for o in (orig, fork, moved, again):
        o.close_logfile()


def test_load_refuses_an_in_memory_cube_session(tmp_path):
    from tools_torch.synthetic import make_minicube as make_cube

    orig = ORIGIN.init(make_cube(nz=40, ny=10, nx=12), name="mem",
                       path=str(tmp_path),
                       loglevel="WARNING", device="cpu")
    orig.write()
    orig.close_logfile()
    with open(tmp_path / "mem" / "mem.yaml") as fh:
        assert yaml.safe_load(fh)["cubename"] is None
    with pytest.raises(ValueError, match="in-memory Cube"):
        ORIGIN.load(str(tmp_path / "mem"), device="cpu")


def test_spectra_file_round_trips_in_both_packages(runs, tmp_path):
    from origin_tpu.pipeline.spectra_io import load_spectra as jload
    from origin_tpu_torch.artifacts.source_creation import _spectra_dict
    from origin_tpu_torch.pipeline.spectra_io import load_spectra

    full = runs["full"]
    fn = os.path.join(full.outpath, "spectra.fits")
    assert os.path.isfile(fn)
    for got in (load_spectra(fn), jload(fn), _spectra_dict(fn)):
        assert list(got) == list(full.spectra)
        for num, sp in full.spectra.items():
            np.testing.assert_array_equal(np.asarray(got[num].data), sp.data)
            np.testing.assert_array_equal(np.asarray(got[num].var), sp.var)
            np.testing.assert_array_equal(got[num].wave.coord(),
                                          sp.wave.coord())
    assert _spectra_dict(str(tmp_path / "none.fits")) == {}


# -- the parameter file -------------------------------------------------------
def test_params_round_trip_through_safe_load():
    tree = {
        "small": 1e-05, "large": 1e20, "negzero": -0.0, "inf": float("inf"),
        "-inf": -float("inf"), "nan": float("nan"), "one": 1.0,
        "unicode": "λ Å   \U0001f52d \"quoted\" \\ \x85\x7f\n",
        "none": None, "yes": True, "no": False, "int": -12,
        "nested": [[1, 2.5e-7, []], {"a": {}, "b": [None, "RUN"]}],
        "statuses": ["NOTRUN", "RUN", "DUMPED", "FAILED"],
        "strings": ["1e-05", "yes", "null", "~", "0x1f", ".inf", ""],
    }
    back = yaml.safe_load(dump_params(tree))
    assert np.isnan(back.pop("nan")) and np.isnan(tree.pop("nan"))
    assert back == tree
    assert np.copysign(1.0, back["negzero"]) == -1.0
    # numpy scalars and arrays, tuples and Status members are sanitized
    tree = dict(f=np.float32(0.1), i=np.int64(3), a=np.arange(3),
                t=(1, 2), s=Status.DUMPED)
    assert yaml.safe_load(dump_params(tree)) == dict(
        f=float(np.float32(0.1)), i=3, a=[0, 1, 2], t=[1, 2], s="DUMPED")


def test_params_of_a_real_session_round_trip(runs):
    param = runs["full"].param
    text = dump_params(param)
    assert yaml.safe_load(text) == _sanitize(param)
    assert yaml.safe_load(text) == yaml.safe_load(
        yaml.safe_dump(_sanitize(param)))
    # the file of step 11's closing write: the tree as it was then (the
    # step's own meta is stamped again once its run returns)
    with open(os.path.join(runs["full"].outpath, "full.yaml")) as fh:
        written = yaml.safe_load(fh)
    now = _sanitize(param)
    for tree in (written, now):
        tree.pop("save_sources")
    assert written == now
