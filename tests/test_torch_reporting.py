"""The torch port's session reporting, ``Detection.det_correl_min``,
``TorchEngine.release`` and the diagnostic plots, against the JAX package.

The minicube (tests/make_minicube.py) runs steps 01-09 in both packages
on the CPU, the JAX package with its power iteration run to its whole
budget (tests/jax_full_budget.py) and written in dense files (its compact
stores off), and the port loads that session (``port_from_jax``):

- ``status()`` prints the JAX session's lines for the same step states
  (a fresh session, after steps 01-09, after the write);
- ``_get_stat()`` of the port's own run equals the JAX dict, counts
  exact and thresholds within 1e-3 (tests/test_torch_pipeline.py's
  tolerance); the loaded session's equals it exactly;
- ``timestat`` has the JAX columns, and the loaded session's table and
  log lines are the JAX session's;
- ``det_correl_min`` gives the JAX indices on the same cube, found on the
  device;
- every ``PlotMixin`` view draws, under the Agg backend, the same images,
  lines and texts as the JAX session's (skipped without matplotlib).
"""

import contextlib
import io
import logging
import os

import numpy as np
import pytest
import torch

from jax_full_budget import jax_full_budget
from make_minicube import make_minicube, make_segmap
from origin_tpu import ORIGIN as JaxORIGIN
from origin_tpu_torch.pipeline.products import Parked, TensorCube
from origin_tpu_torch.pipeline.session import ORIGIN

torch.set_num_threads(2)

STORE_KNOBS = ("ORIGIN_TPU_STORE_RECIPES", "ORIGIN_TPU_STORE_SPARSE",
               "ORIGIN_TPU_STORE_INT16")


def _steps(orig, seg_fn):
    orig.step01_preprocessing()
    orig.step02_areas(minsize=30, maxsize=60)
    orig.step03_compute_PCA_threshold()
    orig.step04_compute_greedy_PCA()
    orig.step05_compute_TGLR()
    orig.step06_compute_purity_threshold(purity=0.8)
    orig.step07_detection(segmap=seg_fn)
    orig.step08_compute_spectra()
    orig.step09_clean_results()
    return orig


def _status(orig):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        orig.status()
    return buf.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("reporting")
    cube_fn, seg_fn = str(path / "minicube.fits"), str(path / "segmap.fits")
    make_minicube(cube_fn)
    make_segmap(seg_fn)
    kw = dict(path=str(path), loglevel="WARNING")
    out = dict(status={})
    with pytest.MonkeyPatch.context() as mp:
        for knob in STORE_KNOBS:
            mp.setenv(knob, "0")
        with jax_full_budget():
            jax = JaxORIGIN.init(cube_fn, name="jax", **kw)
            out["status"]["jax", "fresh"] = _status(jax)
            _steps(jax, seg_fn)
        out["status"]["jax", "run"] = _status(jax)
        jax.write()
        out["status"]["jax", "dumped"] = _status(jax)
        port = ORIGIN.init(cube_fn, name="port", device="cpu", **kw)
        out["status"]["port", "fresh"] = _status(port)
        _steps(port, seg_fn)
        out["status"]["port", "run"] = _status(port)
        out["port_stat"] = port._get_stat()
        out["port_timestat"] = port.timestat(table=True)
        port.write()
        out["status"]["port", "dumped"] = _status(port)
    out.update(jax=jax, port=port, port_from_jax=ORIGIN.load(
        jax.outpath, newname="port_from_jax", device="cpu"))
    yield out
    for key in ("jax", "port", "port_from_jax"):
        out[key].close_logfile()


@pytest.mark.parametrize("state", ["fresh", "run", "dumped"])
def test_status_prints_the_jax_lines(runs, state):
    got = runs["status"]["port", state]
    assert got == runs["status"]["jax", state]
    assert len(got.splitlines()) == 11
    want = dict(fresh="NOTRUN", run="RUN", dumped="DUMPED")[state]
    assert got.splitlines()[8] == f"- 09, clean_results: {want}"


@pytest.mark.parametrize("who", ["run", "loaded"])
def test_get_stat_equals_jax(runs, who):
    want = runs["jax"]._get_stat()
    if who == "loaded":
        assert runs["port_from_jax"]._get_stat() == want
        return
    got = runs["port_stat"]
    assert got.keys() == want.keys()
    for key, value in want.items():
        if key.endswith("threshold"):
            assert got[key] == pytest.approx(value, abs=1e-3), key
        else:
            assert got[key] == value, key
    assert (got["tot_nlines"], got["tot_nsources"],
            got["bright_nsources"]) == (14, 13, 2)


@pytest.mark.parametrize("form", ["table", "log"])
def test_timestat_matches_jax(runs, form, caplog):
    jax, loaded = runs["jax"], runs["port_from_jax"]
    if form == "table":
        want = jax.timestat(table=True)
        for got in (runs["port_timestat"], loaded.timestat(table=True)):
            assert got.colnames == want.colnames == [
                "Step", "Exec Date", "Exec Time"]
            assert list(got["Step"]) == list(want["Step"])
            assert list(got["Step"])[-1] == "Total" and len(got) == 10
        for col in want.colnames:
            assert list(loaded.timestat(table=True)[col]) == list(want[col])
        return
    messages = {}
    for name, orig in (("jax", jax), ("port", loaded)):
        caplog.clear()
        with caplog.at_level(logging.INFO):
            orig.timestat()
        messages[name] = [r.getMessage() for r in caplog.records
                          if "run time" in r.getMessage()]
    assert messages["port"] == messages["jax"] and len(messages["jax"]) == 10


@pytest.mark.parametrize("thresh", [None, 2.0])
def test_det_correl_min_gives_the_jax_indices(runs, thresh):
    loaded = runs["port_from_jax"]
    got = loaded.steps["detection"].det_correl_min(thresh)
    want = runs["jax"].steps["detection"].det_correl_min(thresh)
    assert len(got) == 3 and len(want[0]) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert isinstance(loaded.steps["compute_TGLR"].store.peek(
        "cube_local_min"), TensorCube)


def test_set_loglevel_and_info(runs, capsys):
    loaded = runs["port_from_jax"]
    console = [h for h in loaded.logger.handlers
               if type(h) is logging.StreamHandler]
    loaded.set_loglevel("ERROR")
    assert console[0].level == logging.ERROR
    assert loaded.param["loglevel"] == "ERROR"
    loaded.set_loglevel("WARNING")
    loaded.logger.info("Step 99 finished")
    loaded.logger.info("a line that info() prints")
    loaded.info()
    out = capsys.readouterr().out
    with open(loaded.logfile) as fh:
        want = "".join(line for line in fh if "finished" not in line)
    assert out == want and "a line that info() prints" in out


def test_release_frees_the_device_state(runs, tmp_path):
    """After ``release`` the engine holds no input, a cube read back from
    its session file is parked there again, and a never-written one is
    gone."""
    cube_fn = runs["port"].param["cubename"]
    orig = ORIGIN.init(cube_fn, name="rel", path=str(tmp_path),
                       loglevel="WARNING", device="cpu")
    orig.step01_preprocessing()
    orig.step02_areas(minsize=30, maxsize=60)
    orig.step03_compute_PCA_threshold()
    orig.write()
    std = orig.cube_std.tensor.clone()  # fetched from its recipe file
    orig.step04_compute_greedy_PCA()  # cube_faint: live, never written
    assert orig.engine._inputs
    orig.engine.release()
    assert not orig.engine._inputs
    pre = orig.steps["preprocessing"].store
    assert isinstance(pre.peek("cube_std"), Parked)
    assert orig.steps["compute_greedy_PCA"].store.peek("cube_faint") is None
    np.testing.assert_array_equal(orig.cube_std.tensor.numpy(), std.numpy())
    orig.close_logfile()


PLOTS = {
    "areas": lambda o: o.plot_areas(),
    "step03_PCA_threshold": lambda o: o.plot_step03_PCA_threshold(),
    "step03_PCA_stat": lambda o: o.plot_step03_PCA_stat(),
    "PCA_threshold": lambda o: o.plot_PCA_threshold(1),
    "PCA_threshold_pfa": lambda o: o.plot_PCA_threshold(1, pfa_test=0.02,
                                                        log10=True),
    "mapPCA": lambda o: o.plot_mapPCA(area=1, iteration=1),
    "purity": lambda o: o.plot_purity(),
    "purity_comp": lambda o: o.plot_purity(comp=True, log10=True),
    "NB": lambda o: o.plot_NB(0),
    "sources": lambda o: o.plot_sources(np.asarray(o.Cat1["x0"]),
                                        np.asarray(o.Cat1["y0"])),
    "sources_circle": lambda o: o.plot_sources(
        np.asarray(o.Cat1["x0"]), np.asarray(o.Cat1["y0"]), circle=True,
        title="Cat1"),
    "segmaps": lambda o: o.plot_segmaps(),
    "min_max_hist": lambda o: o.plot_min_max_hist(),
    "min_max_hist_comp": lambda o: o.plot_min_max_hist(comp=True),
}


def _drawn(plt, fn, orig):
    """What ``fn(orig)`` draws: per axes, its images, lines, patches and
    texts."""
    plt.close("all")
    plt.figure()
    fn(orig)
    out = []
    for ax in plt.gcf().axes:
        out.append(dict(
            images=[np.ma.getdata(im.get_array()) for im in ax.images],
            masks=[np.ma.getmaskarray(im.get_array()) for im in ax.images],
            lines=[ln.get_xydata() for ln in ax.lines],
            patches=[p.get_path().vertices for p in ax.patches],
            artists=[getattr(a, "center", None) for a in ax.artists],
            texts=[t.get_text() for t in ax.texts] + [ax.get_title()],
        ))
    plt.close("all")
    return out


@pytest.mark.parametrize("view", PLOTS)
def test_plot_draws_what_jax_draws(runs, view):
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    got = _drawn(plt, PLOTS[view], runs["port_from_jax"])
    want = _drawn(plt, PLOTS[view], runs["jax"])
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.keys() == b.keys()
        assert a["texts"] == b["texts"]
        assert a["artists"] == b["artists"]
        for key in ("images", "masks", "lines", "patches"):
            assert len(a[key]) == len(b[key]), key
            for x, y in zip(a[key], b[key]):
                np.testing.assert_array_equal(x, y, err_msg=f"{view} {key}")
    assert sum(len(a["images"]) + len(a["lines"]) + len(a["patches"])
               for a in got) > 0
