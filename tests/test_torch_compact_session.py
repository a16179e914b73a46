"""Sessions in the JAX package's default, compact files, across the two
packages: recipe files for cube_std, cont_dct and cube_faint, scaled-int16
images for the two correlation cubes and sparse scaled-int16 tables for the
four local-extrema cubes (tests/test_torch_session.py holds the dense ones).

The minicube (tests/make_minicube.py) runs on the CPU with the golden
parameters of tests/test_pipeline.py, every store knob at its default; the
JAX package runs its power iterations to their whole budget
(tests/jax_full_budget.py).

- JAX to port: a JAX session written after step 04 and after step 07
  loads in the port with every cube product of the cube's shape and, bit
  for bit, the JAX package's read of it; the port resumes it to the JAX
  package's own resume of the same folder: Cat1 after step 04 (the
  tolerances of tests/test_torch_pipeline.py), Cat2, Cat3, the mask files
  byte for byte and the source files after step 07 (an int16 ORI_CORREL
  cutout of a JAX source file compared by its decoded values).
- Port to JAX: the port's sessions after steps 04 and 07 load in the JAX
  package product for product bit for bit, and the JAX package resumes the
  one after step 04 to the port's own resume of it (Cat1 as above).
- Port to port: resumed after step 04, Cat0 and Cat1 have the counts of
  the run that never stopped and the correl threshold is within 1e-3 of
  its threshold (cube_faint comes back from its recipe, rebuilt on the host
  in another summation order, and the std extrema from their int16
  tables).
"""

import os

import numpy as np
import pytest
import torch

from jax_full_budget import jax_full_budget
from make_minicube import make_minicube, make_segmap
from origin_tpu import ORIGIN as JaxORIGIN
from origin_tpu_torch.pipeline.session import ORIGIN
from test_torch_pipeline import (
    _assert_same_cat1, _assert_same_table, _listing, _sources,
    assert_same_source_files,
)
from test_torch_session import _blank_timestamps, _front
from test_torch_store import KINDS, KNOBS, file_kind

torch.set_num_threads(2)

STEP04_CUBES = ("cube_std", "cont_dct", "cube_std_local_min",
                "cube_std_local_max", "cube_faint")


def _reads(ours, theirs, names):
    """Per product: (our shape, their shape, equal bit for bit)."""
    out = {}
    for name in names:
        a = getattr(ours, name).data
        b = np.asarray(getattr(theirs, name).data)
        out[name] = (a.shape, b.shape, a.dtype == b.dtype
                     and np.array_equal(a, b))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = tmp_path_factory.mktemp("compact")
    cube_fn, seg_fn = str(path / "minicube.fits"), str(path / "segmap.fits")
    make_minicube(cube_fn)
    make_segmap(seg_fn)
    folder = str(path)
    kw = dict(path=folder, loglevel="WARNING")
    out, reads = {}, {}

    def fork(cls, name, newname, **extra):
        return cls.load(os.path.join(folder, name), newname=newname, **extra)

    with pytest.MonkeyPatch.context() as mp:
        for knob in KNOBS:
            mp.delenv(knob, raising=False)
        # the port: a run that never stopped, and one written after steps
        # 04 and 07
        out["full"] = _front(ORIGIN.init(cube_fn, name="full", device="cpu",
                                         **kw), seg_fn)
        port = _front(ORIGIN.init(cube_fn, name="port", device="cpu", **kw),
                      seg_fn, range(1, 5))
        port.write()
        out["p4"] = fork(ORIGIN, "port", "p4", device="cpu")
        with jax_full_budget():
            out["jp4"] = fork(JaxORIGIN, "port", "jp4")
        _front(port, seg_fn, range(5, 8))
        port.write()
        out["port"] = port
        p7 = fork(ORIGIN, "port", "p7", device="cpu")
        with jax_full_budget():
            jp7 = fork(JaxORIGIN, "port", "jp7")
            reads["port7"] = _reads(p7, jp7, KINDS)
            reads["port4"] = _reads(out["p4"], out["jp4"], STEP04_CUBES)
            # the JAX package, written after steps 04 and 07
            jax = _front(JaxORIGIN.init(cube_fn, name="jax", **kw), seg_fn,
                         range(1, 5))
            jax.write()
            out["pj4"] = fork(ORIGIN, "jax", "pj4", device="cpu")
            out["jj4"] = fork(JaxORIGIN, "jax", "jj4")
            _front(jax, seg_fn, range(5, 8))
            jax.write()
            out["jax"] = jax
            out["pj7"] = fork(ORIGIN, "jax", "pj7", device="cpu")
            out["jj7"] = fork(JaxORIGIN, "jax", "jj7")
            reads["jax4"] = _reads(out["pj4"], out["jj4"], STEP04_CUBES)
            reads["jax7"] = _reads(out["pj7"], out["jj7"], KINDS)
            # each package resumes the other's session and its own copy
            _front(out["jj4"], seg_fn, range(5, 8))
            _front(out["jj7"], seg_fn, range(8, 12))
            _front(out["jp4"], seg_fn, range(5, 8))
        _front(out["pj4"], seg_fn, range(5, 8))
        _front(out["pj7"], seg_fn, range(8, 12))
        _front(out["p4"], seg_fn, range(5, 8))
    for o in (p7, jp7):
        o.close_logfile()
    out["reads"] = reads
    yield out
    for o in out.values():
        if hasattr(o, "close_logfile"):
            o.close_logfile()


@pytest.mark.parametrize("who", ("jax", "port"))
def test_sessions_hold_the_default_kinds(runs, who):
    """3 recipes, 4 sparse tables, 2 scaled-int16 images, 1 dense uint8."""
    folder = runs[who].outpath
    assert {n: file_kind(os.path.join(folder, n + ".fits"))
            for n in KINDS} == KINDS


# -- JAX to port --------------------------------------------------------------
@pytest.mark.parametrize("when", ("jax4", "jax7", "port4", "port7"))
def test_cube_products_read_alike_in_both_packages(runs, when):
    """Each cube product of a session of either package, read by the port
    at the session's start, has the cube's shape and the JAX package's
    values bit for bit (a recipe once came back as its coefficient planes,
    cube_faint as its index vector)."""
    shape = runs["full"].shape
    reads = runs["reads"][when]
    assert len(reads) == (10 if when.endswith("7") else 5)
    for name, (ours, theirs, same) in reads.items():
        assert ours == theirs == shape, name
        assert same, name


def test_port_resumes_a_jax_session_after_step04(runs):
    pj, jj = runs["pj4"], runs["jj4"]
    assert pj.param["threshold"] == pytest.approx(jj.param["threshold"],
                                                  abs=1e-3)
    assert pj.param["threshold_std"] == pytest.approx(
        jj.param["threshold_std"], abs=1e-3)
    assert len(pj.Cat0) == len(jj.Cat0) == 15
    assert len(pj.Cat1) == len(jj.Cat1) == 14
    _assert_same_cat1(pj.Cat1, jj.Cat1)


def test_port_resumes_a_jax_session_after_step07(runs):
    pj, jj = runs["pj7"], runs["jj7"]
    assert len(pj.Cat2) == len(jj.Cat2) == 14
    _assert_same_table(pj.Cat2, jj.Cat2, ("x", "y", "z", "num_line"),
                       ("flux", "residual"), rtol=1e-4)
    _assert_same_table(pj.Cat3_lines, jj.Cat3_lines, ("ID", "merged_in"),
                       ("nsigTGLR", "nsigSTD"), rtol=1e-5)
    _assert_same_table(pj.Cat3_sources, jj.Cat3_sources,
                       ("ID", "n_lines", "comp", "waves"),
                       ("nsigTGLR", "nsigSTD"), rtol=1e-5)
    masks = [os.path.join(o.outpath, "masks") for o in (pj, jj)]
    assert _listing(masks[0]) == _listing(masks[1])
    for name in _listing(masks[0]):
        a, b = (_blank_timestamps(os.path.join(m, name)) for m in masks)
        assert a == b, name
    # the JAX source files' ORI_CORREL cutouts are int16 on a resumed
    # session: the port's reader decodes them
    assert_same_source_files(_sources(pj), _sources(jj),
                             skip_keys=("OR_FSF",))


# -- port to JAX --------------------------------------------------------------
def test_jax_resumes_a_port_session(runs):
    jp, p4 = runs["jp4"], runs["p4"]
    for key in ("threshold", "threshold_std"):
        assert jp.param[key] == pytest.approx(p4.param[key], abs=1e-3)
    assert len(jp.Cat0) == len(p4.Cat0)
    _assert_same_cat1(jp.Cat1, p4.Cat1)


# -- port to port -------------------------------------------------------------
def test_port_resumes_its_own_compact_session(runs):
    full, p4 = runs["full"], runs["p4"]
    assert abs(p4.param["threshold"] - full.param["threshold"]) <= 1e-3
    assert abs(p4.param["threshold_std"] - full.param["threshold_std"]) \
        <= 1e-3
    assert (len(p4.Cat0), len(p4.Cat1)) == (len(full.Cat0),
                                            len(full.Cat1)) == (15, 14)


def test_sessionless_sources_read_the_compact_files(runs, tmp_path):
    """create_all_sources given only the session's file names (no live
    cubes) reads cube_std through its recipe, lazily, and cube_correl from
    its int16 file: the detection-cube cutouts of the files equal those
    that step 11 cut from the session's cubes."""
    from origin_tpu_torch.artifacts.source_creation import create_all_sources

    pj = runs["pj7"]
    out_tpl = str(tmp_path / "source-%0.5d.fits")
    create_all_sources(
        cat3_sources=pj.Cat3_sources, cat3_lines=pj.Cat3_lines,
        origin_params=pj.param,
        cube_cor_filename=os.path.join(pj.outpath, "cube_correl.fits"),
        cube_std_filename=os.path.join(pj.outpath, "cube_std.fits"),
        mask_filename_tpl=pj.param["mask_filename_tpl"],
        skymask_filename_tpl=pj.param["skymask_filename_tpl"],
        spectra_fits_filename=os.path.join(pj.outpath, "spectra.fits"),
        segmaps={"LABEL": pj.segmap_label, "MERGED": pj.segmap_merged},
        version="0.1", profile_fwhm=pj.FWHM_profiles, out_tpl=out_tpl)
    ours = _sources(pj, str(tmp_path))
    theirs = _sources(pj)
    assert list(ours) == list(theirs) and len(ours) == 13
    comps = set()
    for name, src in theirs.items():
        for key in ("ORI_CORREL", "ORI_SNCUBE"):
            if key in src.cubes:
                comps.add(key)
                np.testing.assert_array_equal(ours[name].cubes[key].data,
                                              src.cubes[key].data,
                                              err_msg=name)
    assert comps == {"ORI_CORREL", "ORI_SNCUBE"}
