#!/usr/bin/env python3
"""The minicube's Cat2 and source files from the JAX package, as constants
for chip_smoke.py.

Runs steps 01-11 of the JAX package on the host CPU on the synthetic
minicube (tests/make_minicube.py) with the golden parameters of
tests/test_pipeline.py (areas 30/60, purity 0.8, the test segmap), its
power iterations run to their whole budget (tests/jax_full_budget.py), as
the port runs them, and with ``ORIGIN_TPU_CORREL_WIRE=f32`` (steps 09-11
read the float32 cube_correl, as the port does, not an int16 copy).
Prints ``GOLD_CAT2`` (x, y, z, num_line, flux and residual of each Cat2
row), the Cat3 counts and ``GOLD_SOURCES`` (per source ID: the mask
triple (edge, object pixels, sky pixels), the file's REFSPEC and number
of extensions, and the L2 norms of its MUSE_TOT and REFSPEC spectra), to
paste into chip_smoke.py, which imports no JAX.

Usage: JAX_PLATFORMS=cpu python3 tools_torch/minicube_cat2.py
"""

import os
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    from jax_full_budget import jax_full_budget
    from make_minicube import make_minicube, make_segmap
    from origin_tpu import ORIGIN

    os.environ["ORIGIN_TPU_CORREL_WIRE"] = "f32"
    with tempfile.TemporaryDirectory() as work:
        cube_fn = os.path.join(work, "minicube.fits")
        seg_fn = os.path.join(work, "segmap.fits")
        make_minicube(cube_fn)
        make_segmap(seg_fn)
        with jax_full_budget():
            orig = ORIGIN.init(cube_fn, name="jax_full", path=work,
                               loglevel="WARNING")
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
        cat2 = orig.Cat2
        print("GOLD_CAT2 = dict(")
        for col in ("x", "y", "z", "num_line"):
            vals = ", ".join(str(int(v)) for v in np.asarray(cat2[col]))
            print(f"    {col}=[{vals}],")
        for col in ("flux", "residual"):
            vals = ", ".join(repr(float(v)) for v in np.asarray(cat2[col]))
            print(f"    {col}=[{vals}],")
        print(")")
        comp = np.asarray(orig.Cat3_sources["comp"])
        print(f"# Cat3: {len(orig.Cat3_lines)} lines, "
              f"{len(orig.Cat3_sources)} sources, {int((comp == 1).sum())} "
              "with comp=1")
        print("GOLD_SOURCES = {")
        for sid in np.asarray(orig.Cat3_sources["ID"]):
            print(f"    {int(sid)}: {_source_record(orig.outpath, sid)!r},")
        print("}")
        orig.close_logfile()


def _source_record(outpath, sid):
    """(edge, object pixels, sky pixels, REFSPEC, extensions, |MUSE_TOT|,
    |REFSPEC|) of one source's files."""
    from origin_tpu import fitsio
    from origin_tpu.artifacts import Source

    src_fn = os.path.join(outpath, "masks", "source-mask-%05d.fits" % sid)
    sky_fn = os.path.join(outpath, "masks", "sky-mask-%05d.fits" % sid)
    obj, sky = fitsio.getdata(src_fn), fitsio.getdata(sky_fn)
    fn = os.path.join(outpath, "sources", "source-%05d.fits" % sid)
    src = Source.from_file(fn)
    ref = src.header["REFSPEC"]
    return (int(obj.shape[0]), int(obj.sum()), int((sky == 1).sum()), ref,
            len(fitsio.read(fn)) - 1,
            float(np.linalg.norm(src.spectra["MUSE_TOT"].data)),
            float(np.linalg.norm(src.spectra[ref].data)))


if __name__ == "__main__":
    main()
