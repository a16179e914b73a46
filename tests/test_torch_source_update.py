"""The catalog edits of the torch port (``origin_tpu_torch.artifacts.
source_update``) against the JAX package's.

- ``split_source``, ``merge_sources`` and ``update_source_table`` on the
  catalogs of tests/test_artifacts.py, each edit (and each refused edit)
  made in both packages: the same return value and the same tables,
  column for column.
- ``update_masks`` and ``update_sources`` of both packages for every
  source of one port session written by its step 11 on the minicube
  (tests/make_minicube.py; the default compact files): the port's on the
  loaded session's resident cubes, the JAX package's on the session's
  files.  The 26 masks are equal to each other and to step 10's files;
  the 13 source files agree with each other and with step 11's within the
  tolerances of tests/test_torch_pipeline.py (``assert_same_source_files``,
  the timestamps left out): the detection-cube cutouts at atol 1e-3, which
  holds the int16 files' half step.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from make_minicube import make_minicube, make_segmap
from origin_tpu.artifacts import source_update as jupdate
from origin_tpu.core import Cube as JCube
from origin_tpu.core import Image as JImage
from origin_tpu.core import Table as JTable
from origin_tpu.core.profiles import load_dictionary as jload_dictionary
from origin_tpu.pipeline.recipes import load_cube as jload_cube
from origin_tpu_torch.artifacts import source_update
from origin_tpu_torch.core import Image, Table
from origin_tpu_torch.pipeline.products import TensorCube
from origin_tpu_torch.pipeline.session import ORIGIN
from test_artifacts import _catalog_pair
from test_torch_pipeline import _listing, _sources, assert_same_source_files

torch.set_num_threads(2)

# (function, positional arguments, keyword arguments), or "update" for
# update_source_table after a flux edit
EDITS = {
    "split": ("split_source", (1, [1]), {}),
    "split_in_place": ("split_source", (1, [1]), dict(create_new=False)),
    "split_new_id": ("split_source", (2, [3]), dict(new_id=9)),
    "split_taken_id": ("split_source", (2, [3]), dict(new_id=1)),
    "split_missing_line": ("split_source", (1, [7]), {}),
    "split_unknown_source": ("split_source", (5, [1]), {}),
    "merge": ("merge_sources", (1, [2]), {}),
    "merge_unknown_target": ("merge_sources", (5, [2]), {}),
    "merge_no_lines": ("merge_sources", (1, [8]), {}),
    "update": "update",
}


def _port_table(table):
    return Table(data=[np.array(table[c]) for c in table.colnames],
                 names=list(table.colnames))


def _edit(mod, edit, sources, lines):
    if edit == "update":
        lines["flux"][0] = 100.0
        return mod.update_source_table(1, sources, lines)
    name, args, kwargs = edit
    return getattr(mod, name)(*args, sources, lines, **kwargs)


def _assert_tables_equal(a, b, what):
    assert list(a.colnames) == list(b.colnames) and len(a) == len(b), what
    for col in b.colnames:
        x, y = np.asarray(a[col]), np.asarray(b[col])
        assert x.dtype == y.dtype, (what, col)
        np.testing.assert_array_equal(x, y, err_msg=f"{what} {col}")


@pytest.mark.parametrize("case", EDITS)
def test_catalog_edit_matches_jax(case):
    jsources, jlines = _catalog_pair()
    sources, lines = _port_table(jsources), _port_table(jlines)
    got = _edit(source_update, EDITS[case], sources, lines)
    want = _edit(jupdate, EDITS[case], jsources, jlines)
    assert got == want
    _assert_tables_equal(sources, jsources, "sources")
    _assert_tables_equal(lines, jlines, "lines")
    if case == "split":
        assert got == 3 and len(sources) == 3


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """The port's minicube session after its step 11 (which writes it),
    loaded on the CPU."""
    path = tmp_path_factory.mktemp("update")
    cube_fn, seg_fn = str(path / "minicube.fits"), str(path / "segmap.fits")
    make_minicube(cube_fn)
    make_segmap(seg_fn)
    orig = ORIGIN.init(cube_fn, name="port", path=str(path),
                       loglevel="WARNING", device="cpu")
    orig.step01_preprocessing()
    orig.step02_areas(minsize=30, maxsize=60)
    orig.step03_compute_PCA_threshold()
    orig.step04_compute_greedy_PCA()
    orig.step05_compute_TGLR()
    orig.step06_compute_purity_threshold(purity=0.8)
    orig.step07_detection(segmap=seg_fn)
    orig.step08_compute_spectra()
    orig.step09_clean_results()
    orig.step10_create_masks()
    orig.step11_save_sources("0.1")
    orig.close_logfile()
    loaded = ORIGIN.load(orig.outpath, device="cpu")
    yield loaded
    loaded.close_logfile()


def _jax_inputs(orig):
    """The JAX package's objects read from the session's files."""
    folder = orig.outpath

    def fn(name):
        return os.path.join(folder, name + ".fits")

    param = yaml.safe_load(open(os.path.join(folder, orig.name + ".yaml")))
    return dict(
        param=param, lines=JTable.read(fn("Cat3_lines")),
        sources=JTable.read(fn("Cat3_sources")),
        profile_fwhm=jload_dictionary(param["profiles"])[1],
        cube_correl=JCube(fn("cube_correl")),
        cube_std=jload_cube(fn("cube_std")),
        segmap_label=JImage(fn("segmap_label")),
        segmap_merged=JImage(fn("segmap_merged")),
        fwhm=np.asarray(param["LBDA FWHM PSF"]),
    )


@pytest.fixture(scope="module")
def updates(session, tmp_path_factory):
    """Every source's masks and files, refreshed by both packages."""
    out = tmp_path_factory.mktemp("updated")
    orig = session
    ids = [int(i) for i in orig.Cat3_sources["ID"]]
    assert isinstance(orig.cube_correl, TensorCube)
    assert isinstance(orig.cube_std, TensorCube)
    j = _jax_inputs(orig)
    for sub in ("port_masks", "jax_masks", "port_sources", "jax_sources"):
        os.makedirs(out / sub)
    source_update.update_masks(
        ids, orig.Cat3_lines, orig.Cat3_sources, orig.FWHM_profiles,
        orig.cube_correl, orig.threshold_correl, orig.cube_std,
        orig.threshold_std, orig.segmap_label, orig.LBDA_FWHM_PSF,
        str(out / "port_masks"), plot_problems=False)
    jupdate.update_masks(
        ids, j["lines"], j["sources"], j["profile_fwhm"], j["cube_correl"],
        j["param"]["threshold"], j["cube_std"], j["param"]["threshold_std"],
        j["segmap_label"], j["fwhm"], str(out / "jax_masks"),
        plot_problems=False)

    def files(folder, name):
        return os.path.join(folder, name + ".fits")

    common = (orig.param["mask_filename_tpl"],
              orig.param["skymask_filename_tpl"],
              files(orig.outpath, "spectra"))
    # both with the parameter file's tree, which step 11 wrote from its
    # own (a loaded session's PSF names its cube_psf.fits)
    source_update.update_sources(
        ids, orig.Cat3_sources, orig.Cat3_lines, j["param"],
        files(orig.outpath, "cube_correl"), files(orig.outpath, "cube_std"),
        *common, {"LABEL": orig.segmap_label, "MERGED": orig.segmap_merged},
        "0.1", orig.FWHM_profiles, str(out / "port_sources" /
                                       "source-%0.5d.fits"))
    jupdate.update_sources(
        ids, j["sources"], j["lines"], j["param"],
        files(orig.outpath, "cube_correl"), files(orig.outpath, "cube_std"),
        *common, {"LABEL": j["segmap_label"], "MERGED": j["segmap_merged"]},
        "0.1", j["profile_fwhm"], str(out / "jax_sources" /
                                      "source-%0.5d.fits"))
    return dict(orig=orig, out=out, ids=ids)


@pytest.mark.parametrize("ref", ["jax", "step10"])
def test_update_masks_matches(updates, ref):
    out, orig = updates["out"], updates["orig"]
    ours = str(out / "port_masks")
    theirs = (str(out / "jax_masks") if ref == "jax"
              else os.path.join(orig.outpath, "masks"))
    names = _listing(ours)
    assert names == _listing(theirs) and len(names) == 2 * len(
        updates["ids"]) == 26
    for name in names:
        a, b = Image(os.path.join(ours, name)), Image(os.path.join(theirs,
                                                                   name))
        assert a.data.dtype == b.data.dtype, name
        np.testing.assert_array_equal(a.data, b.data, err_msg=name)
        assert tuple(a.wcs.crpix) == tuple(b.wcs.crpix), name


@pytest.mark.parametrize("ref", ["jax", "step11"])
def test_update_sources_matches(updates, ref):
    out, orig = updates["out"], updates["orig"]
    theirs = (str(out / "jax_sources") if ref == "jax"
              else os.path.join(orig.outpath, "sources"))
    assert_same_source_files(_sources(orig, str(out / "port_sources")),
                             _sources(orig, theirs))
