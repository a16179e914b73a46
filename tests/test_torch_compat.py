"""Sessions in the reference package's dialect in the torch port
(``origin_tpu_torch.pipeline.compat``), against the JAX package's module.

- The reader: the five cases of tests/test_compat.py (the dialect, the
  Status payload forms, old PyYAML's OrderedDict listitems, an ndarray
  payload, unregistered python tags), each read by both packages, which
  must give equal trees.
- The writer: ``dumps_reference_params`` of a JAX session's parameter
  tree after step 09 is the JAX package's text byte for byte.
- The port's export of its session after step 09 has the file names of
  the JAX package's export of its own; every dense product file holds the
  port's live product bit for bit; it loads in both packages with the
  same statuses and products.
- The JAX package's export after step 04 (its power iteration run to its
  whole budget, tests/jax_full_budget.py) resumes in the port, steps
  05-07, to the goldens: correl threshold 4.5642 within 1e-4, std
  threshold 4.8666 within 1e-4, Cat0 / Cat1 15 / 14.
- A session whose parameter file is re-dumped in the reference dialect,
  with a profile dictionary path that no longer exists, loads in the port
  and resumes step 04 to the uninterrupted run's cube_faint.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from jax_full_budget import jax_full_budget
from make_minicube import make_minicube, make_segmap
from origin_tpu import ORIGIN as JaxORIGIN
from origin_tpu.pipeline import compat as jcompat
from origin_tpu.pipeline.session import _sanitize as jsanitize
from origin_tpu_torch import fitsio
from origin_tpu_torch.core import Cube, Table
from origin_tpu_torch.pipeline import compat
from origin_tpu_torch.pipeline.products import TensorCube
from origin_tpu_torch.pipeline.session import ORIGIN
from origin_tpu_torch.pipeline.steps import Status
from test_compat import _RefDumper, _RefStatusTag, _np_scalar_yaml

torch.set_num_threads(2)

PACKAGES = {"jax": jcompat, "port": compat}
STORE_KNOBS = ("ORIGIN_TPU_STORE_RECIPES", "ORIGIN_TPU_STORE_SPARSE",
               "ORIGIN_TPU_STORE_INT16")
CUBE_PRODUCTS = ("cube_std", "cont_dct", "cube_std_local_min",
                 "cube_std_local_max", "cube_faint", "cube_correl",
                 "cube_correl_min", "cube_profile", "cube_local_min",
                 "cube_local_max")


# -- the reader ---------------------------------------------------------------
def _ndarray_text():
    import base64

    payload = base64.b64encode(np.array([1.5, 2.5, 3.25]).tobytes()).decode()
    return (
        "fwhm: !!python/object/apply:numpy.core.multiarray._reconstruct\n"
        "  args:\n"
        "  - !!python/name:numpy.ndarray ''\n"
        "  - !!python/tuple [0]\n"
        "  - !!binary |\n"
        "    Yg==\n"
        "  state: !!python/tuple\n"
        "  - 1\n"
        "  - !!python/tuple [3]\n"
        "  - !!python/object/apply:numpy.dtype\n"
        "    args: [f8, 0, 1]\n"
        "    state: !!python/tuple [3, <, null, null, null, -1, -1, 0]\n"
        "  - false\n"
        "  - !!binary |\n"
        f"    {payload}\n"
    )


READER_CASES = {
    "dialect": (
        "cubename: /data/cube.fits\n"
        "loglevel: DEBUG\n"
        "logcolor: false\n"
        "profiles: /somewhere/Dico_3FWHM.fits\n"
        "threshold: " + _np_scalar_yaml(4.125, "f8")
        + "nbareas: " + _np_scalar_yaml(4, "i8")
        + "preprocessing:\n"
        "  stepidx: 1\n"
        "  params: {dct_order: 10}\n"
        "  status: !!python/object/apply:muse_origin.steps.Status\n"
        "  - dumped outputs\n"
        "  runtime: 9.62\n"
        "somepair: !!python/tuple [1, 2]\n"
        "weird: !!python/object/apply:some.unknown.Thing [5]\n"
        "aname: !!python/name:numpy.median ''\n",
        dict(threshold=4.125, nbareas=4, somepair=[1, 2], weird=5,
             aname="numpy.median"),
    ),
    "ordereddict_listitems": (
        "preprocessing: !!python/object/apply:collections.OrderedDict\n"
        "  listitems:\n"
        "  - [status, dumped]\n"
        "  - [runtime, 9.62]\n",
        dict(preprocessing={"status": "dumped", "runtime": 9.62}),
    ),
    "ndarray": (_ndarray_text(), dict(fwhm=[1.5, 2.5, 3.25])),
    "unregistered_tags": (
        "c: !!python/complex 3.0+4.0j\n"
        "m: !!python/module:some.module ''\n"
        "obj: !!python/object/new:some.Thing {args: [7]}\n",
        dict(c=complex(3.0, 4.0), m="", obj=7),
    ),
}


@pytest.mark.parametrize("pkg", PACKAGES)
@pytest.mark.parametrize("case", [*READER_CASES, "status_payloads"])
def test_reader_gives_the_jax_tree(case, pkg):
    """Each case read by ``pkg``: the values of tests/test_compat.py, and
    the same tree (types included) as the other package's."""
    mod, other = PACKAGES[pkg], PACKAGES["port" if pkg == "jax" else "jax"]
    if case == "status_payloads":
        for arg, want in (("dumped outputs", "DUMPED"), ("DUMPED", "DUMPED"),
                          (2, "RUN"), (4, "FAILED")):
            assert mod._status_name(arg) == other._status_name(arg) == want
        for bad in ("nonsense", 0):
            with pytest.raises(ValueError):
                mod._status_name(bad)
        return
    text, want = READER_CASES[case]
    assert mod.looks_like_reference_yaml(text)
    tree = mod.loads_params(text)
    for key, value in want.items():
        assert tree[key] == value and type(tree[key]) is type(value), key
    assert tree == other.loads_params(text)
    assert [type(v) for v in tree.values()] == [
        type(v) for v in other.loads_params(text).values()]
    if case == "dialect":
        assert tree["preprocessing"]["status"] == "DUMPED"
        assert not mod.looks_like_reference_yaml("a: 1\nb: [2, 3]\n")


# -- sessions -----------------------------------------------------------------
def _steps(orig, seg_fn, steps):
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
    }
    for i in steps:
        calls[i]()
    return orig


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("compat")
    cube_fn, seg_fn = str(path / "minicube.fits"), str(path / "segmap.fits")
    make_minicube(cube_fn)
    make_segmap(seg_fn)
    folder = str(path)
    for sub in ("jax4", "jax9", "port9"):
        os.makedirs(os.path.join(folder, sub))
    kw = dict(path=folder, loglevel="WARNING")
    out = dict(seg_fn=seg_fn, folder=folder)
    with jax_full_budget():
        jax = _steps(JaxORIGIN.init(cube_fn, name="jax", **kw), seg_fn,
                     range(1, 5))
        out["jax4"] = jax.write(path=os.path.join(folder, "jax4"),
                                compat="reference")
        _steps(jax, seg_fn, range(5, 10))
        out["jax9"] = jax.write(path=os.path.join(folder, "jax9"),
                                compat="reference")
    out["jax"] = jax
    port = _steps(ORIGIN.init(cube_fn, name="port", device="cpu", **kw),
                  seg_fn, range(1, 10))
    out["port9"] = port.write(path=os.path.join(folder, "port9"),
                              compat="reference")
    out["port"] = port
    # the port's export in both packages
    out["port9_in_jax"] = JaxORIGIN.load(out["port9"], newname="p9_jax")
    out["port9_in_port"] = ORIGIN.load(out["port9"], newname="p9_port",
                                       device="cpu")
    # the JAX package's export after step 04, resumed in the port
    resumed = ORIGIN.load(out["jax4"], newname="jax4_port", device="cpu")
    out["jax4_port"] = _steps(resumed, seg_fn, range(5, 8))
    yield out
    for key in ("jax", "port", "port9_in_jax", "port9_in_port", "jax4_port"):
        out[key].close_logfile()


@pytest.mark.parametrize("dumped", ["none", "all"])
def test_writer_gives_the_jax_text(runs, dumped):
    jax = runs["jax"]
    names = list(jax.steps)
    done = names if dumped == "all" else ()
    param = jsanitize(jax.param)
    text = compat.dumps_reference_params(param, names, done)
    assert text == jcompat.dumps_reference_params(param, names, done)
    assert text.count("python/object/apply:muse_origin.steps.Status") == sum(
        "status" in param[n] for n in names) == 9


def test_port_export_has_the_jax_file_names(runs):
    ours = sorted(n.replace("port", "jax") for n in os.listdir(runs["port9"]))
    assert ours == sorted(os.listdir(runs["jax9"]))
    assert "jax.yaml" in ours and "cube_correl.fits" in ours
    text = open(os.path.join(runs["port9"], "port.yaml")).read()
    assert compat.looks_like_reference_yaml(text)


def _file_array(path):
    """The data of a dense product file (no recipe, sparse or int16
    form)."""
    phdr, dhdr = fitsio.getheader(path, 0), fitsio.getheader(path, 1)
    assert "ORITPURE" not in phdr and "ORITPUSP" not in phdr, path
    assert "BSCALE" not in dhdr, path
    return fitsio.getdata(path)


def test_port_export_holds_the_live_products_bit_for_bit(runs):
    port, folder = runs["port"], runs["port9"]
    checked = set()
    for step in port.steps.values():
        for name, kind in step.store.spec.items():
            live = step.store.peek(name)
            path = step.store.file_for(name, folder)
            if kind == "cube":
                assert isinstance(live, TensorCube), name
                got = _file_array(path)
                want = live.tensor.numpy()
                assert got.dtype == want.dtype, name
                np.testing.assert_array_equal(got, want, err_msg=name)
            elif kind == "image":
                got = _file_array(path)
                np.testing.assert_array_equal(got, np.asarray(live.data),
                                              err_msg=name)
            elif kind == "table":
                got = Table.read(path)
                assert got.colnames == live.colnames, name
                for col in live.colnames:
                    np.testing.assert_array_equal(np.asarray(got[col]),
                                                  np.asarray(live[col]),
                                                  err_msg=f"{name} {col}")
            else:
                continue
            checked.add(kind)
    assert checked == {"cube", "image", "table"}


@pytest.mark.parametrize("loader", ["port9_in_jax", "port9_in_port"])
def test_port_export_loads_in_both_packages(runs, loader):
    port, loaded = runs["port"], runs[loader]
    assert [s.status.name for s in port.steps.values()] == (
        ["RUN"] * 9 + ["NOTRUN"] * 2)
    got = [s.status.name for s in loaded.steps.values()]
    assert got == ["DUMPED"] * 9 + ["NOTRUN"] * 2
    for key in ("threshold", "threshold_std", "nbareas"):
        assert loaded.param[key] == port.param[key], key
    for name in ("cube_std", "cube_faint", "cube_correl", "cube_profile",
                 "cube_local_max"):
        got = np.asarray(getattr(loaded, name).data)
        want = getattr(port, name).tensor.numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in ("Cat1", "Cat3_sources"):
        a, b = getattr(loaded, name), getattr(port, name)
        assert a.colnames == b.colnames and len(a) == len(b) > 0
        for col in b.colnames:
            np.testing.assert_array_equal(np.asarray(a[col]),
                                          np.asarray(b[col]), err_msg=col)
    assert sorted(loaded.spectra) == sorted(port.spectra)


def test_jax_export_resumes_in_the_port_to_the_goldens(runs):
    orig = runs["jax4_port"]
    assert [s.status for s in orig.steps.values()][:7] == (
        [Status.DUMPED] * 4 + [Status.RUN] * 3)
    assert isinstance(orig.steps["compute_greedy_PCA"].store.peek(
        "cube_faint"), TensorCube)
    assert orig.param["threshold"] == pytest.approx(4.5642, abs=1e-4)
    assert orig.param["threshold_std"] == pytest.approx(4.8666, abs=1e-4)
    assert (len(orig.Cat0), len(orig.Cat1)) == (15, 14)


def test_hand_built_reference_session_resumes_step04(runs, tmp_path,
                                                     monkeypatch):
    """The port's session after step 03 in dense files, its parameter file
    re-dumped in the reference dialect with a dead dictionary path (as in
    tests/test_compat.py::test_load_reference_session): the port loads it
    with the packaged dictionary and resumes step 04 to the uninterrupted
    run's cube_faint."""
    for knob in STORE_KNOBS:
        monkeypatch.setenv(knob, "0")
    port = runs["port"]
    orig = _steps(ORIGIN.init(port.param["cubename"], name="refsess",
                              path=str(tmp_path), loglevel="WARNING",
                              device="cpu"), runs["seg_fn"], range(1, 4))
    thres = [float(t) for t in orig.thresO2]
    orig.write()
    orig.close_logfile()

    yfile = tmp_path / "refsess" / "refsess.yaml"
    param = yaml.safe_load(yfile.read_text())
    for val in param.values():
        if isinstance(val, dict) and "status" in val:
            val["status"] = _RefStatusTag(val["status"])
    param["profiles"] = "/nonexistent/elsewhere/Dico_3FWHM.fits"
    yfile.write_text(yaml.dump(param, Dumper=_RefDumper))
    assert compat.looks_like_reference_yaml(yfile.read_text())

    loaded = ORIGIN.load(str(tmp_path / "refsess"), device="cpu")
    try:
        assert [s.status for s in loaded.steps.values()][:4] == (
            [Status.DUMPED] * 3 + [Status.NOTRUN])
        assert [float(t) for t in loaded.thresO2] == thres
        assert os.path.isfile(loaded.param["profiles"])
        assert loaded.param["profiles"].startswith(os.path.dirname(
            os.path.dirname(compat.__file__)))
        loaded.step04_compute_greedy_PCA()
        np.testing.assert_array_equal(loaded.cube_faint.tensor.numpy(),
                                      port.cube_faint.tensor.numpy())
        np.testing.assert_array_equal(loaded.mapO2.data, port.mapO2.data)
    finally:
        loaded.close_logfile()


def test_export_of_a_compact_session_holds_what_fetch_gives(runs,
                                                            tmp_path):
    """A port session after step 05 written in the default compact files
    (recipes, scaled-int16 images, sparse tables) and loaded: its export
    holds, in each dense cube file, what the loaded session's fetch gives,
    bit for bit."""
    orig = _steps(ORIGIN.init(runs["port"].param["cubename"], name="compact",
                              path=str(tmp_path), loglevel="WARNING",
                              device="cpu"), runs["seg_fn"], range(1, 6))
    orig.write()
    orig.close_logfile()
    kinds = {}
    for name in CUBE_PRODUCTS:
        fn = str(tmp_path / "compact" / f"{name}.fits")
        phdr, dhdr = fitsio.getheader(fn, 0), fitsio.getheader(fn, 1)
        kinds[name] = (phdr.get("ORITPURE")
                       or ("sparse" if phdr.get("ORITPUSP") else None)
                       or ("int16" if "BSCALE" in dhdr else dhdr["BITPIX"]))
    assert sorted(set(kinds.values()), key=str) == [
        8, "dct_cont", "dct_std", "int16", "pca_faint", "sparse"], kinds
    loaded = ORIGIN.load(str(tmp_path / "compact"), device="cpu")
    exp = tmp_path / "exp"
    exp.mkdir()
    try:
        folder = loaded.write(path=str(exp), compat="reference")
        assert folder == str(exp / "compact")
        for name in CUBE_PRODUCTS:
            fetched = getattr(loaded, name).tensor.numpy()
            got = _file_array(os.path.join(folder, name + ".fits"))
            assert got.dtype == fetched.dtype, name
            np.testing.assert_array_equal(got, fetched, err_msg=name)
        assert Cube(os.path.join(folder, "cube_std.fits")).shape == (
            loaded.cube_std.shape)
    finally:
        loaded.close_logfile()
