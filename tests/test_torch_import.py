"""The torch port imports nothing of jax, yaml, joblib, tqdm or the JAX
package; its device is explicit; its copies of the JAX package's host substrate
(``core``, ``fitsio``, ``native``, the dictionaries and the synthetic
cubes of ``tools_torch/synthetic.py``) behave as the originals do."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.join(REPO, "tests")
# the cube products of steps 01, 04 and 05, one session file each
CUBE_PRODUCTS = ("cube_std", "cont_dct", "cube_std_local_min",
                 "cube_std_local_max", "cube_faint", "cube_correl",
                 "cube_correl_min", "cube_profile", "cube_local_min",
                 "cube_local_max")


def test_port_runs_without_jax_or_yaml(tmp_path):
    # steps 01-11, step 11 ending in the session write; the card's machine
    # has no joblib or tqdm
    code = textwrap.dedent(f"""
        import os, sys
        for name in ("jax", "yaml", "joblib", "tqdm", "origin_tpu"):
            sys.modules[name] = None
        sys.path[:0] = [{REPO!r}]
        import torch
        torch.set_num_threads(2)
        import origin_tpu_torch.pipeline.session as session
        import origin_tpu_torch.convert, origin_tpu_torch.ops.sweep
        import origin_tpu_torch.ops.build, origin_tpu_torch.ops.kernels
        import origin_tpu_torch.ops.spatial
        from tools_torch.synthetic import make_minicube, make_segmap

        CUBE_PRODUCTS = {CUBE_PRODUCTS!r}

        path = {str(tmp_path / "mini.fits")!r}
        seg = {str(tmp_path / "seg.fits")!r}
        make_minicube(path)
        make_segmap(seg)
        counts = {{}}
        for prec in ("highest", "bf16x3"):
            os.environ["ORIGIN_TPU_PRECISION"] = prec
            orig = session.ORIGIN.init(path, device="cpu",
                                       path={str(tmp_path)!r}, name=prec,
                                       loglevel="WARNING")
            assert orig.engine.device.type == "cpu"
            # a fresh session given a file name takes the streamed ingest
            # (pipeline/ingest.py), held here to import no jax
            with open(orig.logfile) as fh:
                assert "ingest: streamed" in fh.read()
            assert orig.engine._staged is not None
            assert orig.engine.input_cube().device.type == "cpu"
            orig.step01_preprocessing()
            orig.step02_areas(minsize=30, maxsize=60)
            orig.step03_compute_PCA_threshold()
            orig.step04_compute_greedy_PCA()
            orig.step05_compute_TGLR()
            orig.step06_compute_purity_threshold(purity=0.8)
            orig.step07_detection(segmap=seg)
            counts[prec] = (len(orig.Cat0), len(orig.Cat1))
            if prec == "highest":
                orig.step08_compute_spectra()
                orig.step09_clean_results()
                counts["cat3"] = (len(orig.Cat3_lines),
                                  len(orig.Cat3_sources))
                orig.step10_create_masks()
                orig.step11_save_sources("0.1", n_jobs=2)
                counts["files"] = tuple(
                    len(os.listdir(os.path.join(orig.outpath, d)))
                    for d in ("masks", "sources"))
                for fn in (orig.name + ".yaml", "cube_psf.fits",
                           *(n + ".fits" for n in CUBE_PRODUCTS)):
                    assert os.path.isfile(os.path.join(orig.outpath, fn)), fn
                # the closing write stores the JAX package's compact kinds
                from origin_tpu_torch import fitsio
                kinds = {{}}
                for n in CUBE_PRODUCTS:
                    fn = os.path.join(orig.outpath, n + ".fits")
                    phdr, dhdr = (fitsio.getheader(fn, i) for i in (0, 1))
                    kinds[n] = (phdr.get("ORITPURE") or phdr.get("ORITPUSP")
                                or ("int16" if "BSCALE" in dhdr
                                    else dhdr["BITPIX"]))
                sparse = dict.fromkeys(CUBE_PRODUCTS[2:4] + CUBE_PRODUCTS[8:],
                                       "extrema16")
                assert kinds == dict(
                    sparse, cube_std="dct_std", cont_dct="dct_cont",
                    cube_faint="pca_faint", cube_correl="int16",
                    cube_correl_min="int16", cube_profile=8), kinds
            orig.close_logfile()
        assert counts == {{"highest": (15, 14), "bf16x3": (15, 14),
                           "cat3": (14, 13), "files": (26, 13)}}, counts
        if not torch.cuda.is_available():
            try:
                session.ORIGIN.init(path, device="cuda",
                                    path={str(tmp_path)!r}, name="gpu")
            except RuntimeError as exc:
                assert "cuda" in str(exc)
            else:
                raise AssertionError("device='cuda' did not raise")
        loaded = [m for m, v in sys.modules.items() if v is not None
                  and m.split(".")[0] in ("jax", "yaml", "joblib", "tqdm",
                                          "origin_tpu")]
        assert not loaded, loaded
        print("PORT-OK")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path))
    tails = (f"rc {res.returncode}\n--- stdout:\n{res.stdout[-3000:]}\n"
             f"--- stderr:\n{res.stderr[-3000:]}")
    assert res.returncode == 0, tails
    assert "PORT-OK" in res.stdout, tails


def test_mesh_and_mosaic_tools_run_without_jax(tmp_path):
    """``origin_tpu_torch.parallel`` and the two mosaic tools import
    nothing of jax or of the JAX package: a mesh session's steps 01-07
    and a sharded batch run with both set to None in ``sys.modules``."""
    code = textwrap.dedent(f"""
        import sys
        for name in ("jax", "origin_tpu"):
            sys.modules[name] = None
        sys.path[:0] = [{REPO!r}]
        import numpy as np
        import torch
        torch.set_num_threads(2)
        import origin_tpu_torch.parallel as par
        from origin_tpu_torch.pipeline.session import ORIGIN
        from tools_torch import mosaic_batch, mosaic_distributed
        from tools_torch.synthetic import make_minicube

        path = {str(tmp_path / "m.fits")!r}
        make_minicube(path, nz=120, ny=32, nx=24)
        mesh = par.make_mesh(4, dp=1, devices=["cpu"] * 4)
        orig = ORIGIN.init(path, device="cpu", path={str(tmp_path)!r},
                           name="mesh", loglevel="WARNING", PSF_size=9,
                           mesh=mesh)
        orig.step01_preprocessing()
        orig.step02_areas(minsize=12, maxsize=24)
        orig.step03_compute_PCA_threshold()
        orig.step04_compute_greedy_PCA()
        orig.step05_compute_TGLR()
        orig.step06_compute_purity_threshold(purity=0.8)
        orig.step07_detection()
        orig.close_logfile()
        psf, profiles = mosaic_batch.instrument(120, psf_size=7)
        pipe = par.ShardedPipeline(par.make_mesh(4, dp=2,
                                                 devices=["cpu"] * 4),
                                   120, 32, 24, psf, profiles)
        res = mosaic_batch.run_batches(pipe, [path, path], dp=2)
        assert np.array_equal(res[0][1], res[1][1])
        loaded = [m for m, v in sys.modules.items() if v is not None
                  and m.split(".")[0] in ("jax", "origin_tpu")]
        assert not loaded, loaded
        print("MESH-OK")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path))
    tails = (f"rc {res.returncode}\n--- stdout:\n{res.stdout[-3000:]}\n"
             f"--- stderr:\n{res.stderr[-3000:]}")
    assert res.returncode == 0, tails
    assert "MESH-OK" in res.stdout, tails


def test_unported_entry_points_name_the_roadmap(tmp_path):
    import shutil

    from make_minicube import make_minicube
    from origin_tpu_torch.__main__ import main
    from origin_tpu_torch.pipeline.session import ORIGIN

    path = str(tmp_path / "tiny.fits")
    make_minicube(path, nz=40, ny=10, nx=12)
    # the CLI's --overlap-ingest, the reference dialect and the multi-GPU
    # mesh, which raised here before, are ported
    # (tests/test_torch_ingest.py, tests/test_torch_compat.py,
    # tests/test_torch_parallel.py)
    second = str(tmp_path / "tiny2.fits")
    shutil.copy(path, second)
    assert main(["run", path, second, "--name", "ovl", "--path",
                 str(tmp_path), "--device", "cpu", "--no-sources",
                 "--minsize", "4", "--loglevel", "WARNING",
                 "--overlap-ingest"]) == 0
    for stem in ("tiny", "tiny2"):
        assert os.path.isfile(str(tmp_path / f"ovl-{stem}" / "Cat1.fits"))
    orig = ORIGIN.init(path, device="cpu", path=str(tmp_path), name="t",
                       loglevel="WARNING")
    ref = tmp_path / "ref"
    ref.mkdir()
    assert orig.write(path=str(ref), compat="reference") == str(ref / "t")
    assert [s.method_name for s in orig.steps.values()] == [
        "step01_preprocessing", "step02_areas",
        "step03_compute_PCA_threshold", "step04_compute_greedy_PCA",
        "step05_compute_TGLR", "step06_compute_purity_threshold",
        "step07_detection", "step08_compute_spectra",
        "step09_clean_results", "step10_create_masks",
        "step11_save_sources",
    ]
    orig.close_logfile()


def test_user_surface_imports_and_runs_without_jax(tmp_path):
    """The CLI, the reference dialect, the catalog edits and the plots
    import with jax, yaml, matplotlib and the JAX package blocked, and the
    CLI runs a cube through step 09 and its closing write on the CPU."""
    code = textwrap.dedent(f"""
        import os, sys
        for name in ("jax", "yaml", "matplotlib", "origin_tpu"):
            sys.modules[name] = None
        sys.path[:0] = [{REPO!r}]
        import torch
        torch.set_num_threads(2)
        import origin_tpu_torch.__main__ as cli
        import origin_tpu_torch.pipeline.compat
        import origin_tpu_torch.artifacts.source_update
        import origin_tpu_torch.pipeline.plotting
        from tools_torch.synthetic import make_minicube

        cube = {str(tmp_path / "mini.fits")!r}
        make_minicube(cube, nz=300, ny=40, nx=40)
        rc = cli.main(["run", cube, "--name", "cli", "--path",
                       {str(tmp_path)!r}, "--purity", "0.8", "--minsize",
                       "20", "--no-sources", "--loglevel", "WARNING",
                       "--device", "cpu"])
        assert rc == 0, rc
        assert os.path.isfile({str(tmp_path / "cli" / "cli.yaml")!r})
        loaded = [m for m, v in sys.modules.items() if v is not None
                  and m.split(".")[0] in ("jax", "yaml", "matplotlib",
                                          "origin_tpu")]
        assert not loaded, loaded
        print("SURFACE-OK")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=str(tmp_path))
    tails = (f"rc {res.returncode}\n--- stdout:\n{res.stdout[-3000:]}\n"
             f"--- stderr:\n{res.stderr[-3000:]}")
    assert res.returncode == 0, tails
    assert "SURFACE-OK" in res.stdout, tails


def test_device_is_explicit():
    import pytest

    from origin_tpu_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device(None)
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")


@pytest.mark.parametrize("name", ["toeplitz_sweep", "sweep_bf16x3",
                                  "spatial_fsf"])
def test_kernel_build_without_nvcc_raises_with_the_spill_rule(
        name, monkeypatch):
    """No fallback: a kernel that cannot be built raises and names its
    command, whose ptxas flags fail any spill or local-memory use."""
    from origin_tpu_torch.ops import build

    assert name in build.KERNELS
    monkeypatch.setattr(build, "_find_nvcc", lambda: None)
    monkeypatch.setattr(build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found") as exc:
        build.load_library(name)
    assert f"{name}.cu" in str(exc.value)
    assert "-Xptxas=-v,-warn-spills,-warn-lmem-usage,-Werror" in str(
        exc.value)


# -- the port's copies against the JAX package's originals -------------------
def test_dictionaries_load_equal():
    from origin_tpu.core import profiles as jprof
    from origin_tpu_torch.core import profiles as tprof

    for name in (tprof.DICO_3FWHM, tprof.DICO_FWHM_2_12):
        path = tprof.default_dictionary_path(name)
        assert path.startswith(os.path.join(REPO, "origin_tpu_torch"))
        ours, fwhm = tprof.load_dictionary(path)
        ref, rfwhm = jprof.load_dictionary(jprof.default_dictionary_path(name))
        assert len(ours) == len(ref) and len(ours) in (3, 20)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(fwhm, rfwhm)


def test_fsf_header_and_fields_map_read_back_equal(tmp_path):
    from origin_tpu.core import Cube as JCube
    from origin_tpu.core import FieldsMap as JFieldsMap
    from origin_tpu.core import read_fsf_from_header as jread
    from origin_tpu_torch.core import Cube, FieldsMap, read_fsf_from_header
    from tools_torch.synthetic import make_minicube

    path = str(tmp_path / "cube.fits")
    make_minicube(path, nz=30, ny=12, nx=14)
    ours, ref = Cube(path), JCube(path)
    np.testing.assert_array_equal(np.asarray(ours.data),
                                  np.asarray(ref.data))
    lbda = ours.wave.coord()
    np.testing.assert_array_equal(lbda, ref.wave.coord())
    fsf = read_fsf_from_header(ours.primary_header, pixstep=0.2)
    jfsf = jread(ref.primary_header, pixstep=0.2)
    np.testing.assert_array_equal(fsf.get_3darray(lbda, (25, 25)),
                                  jfsf.get_3darray(lbda, (25, 25)))
    np.testing.assert_array_equal(fsf.get_fwhm(lbda, unit="pix"),
                                  jfsf.get_fwhm(lbda, unit="pix"))
    fmap = np.zeros((12, 14), int)
    fmap[:, :8], fmap[4:, 6:] = 1, 2
    for a, b in zip(FieldsMap(data=fmap, nfields=2).compute_weights(),
                    JFieldsMap(data=fmap, nfields=2).compute_weights()):
        np.testing.assert_array_equal(a, b)


def test_table_vstack_and_join_equal():
    from origin_tpu.core import Table as JTable
    from origin_tpu.core import join as jjoin
    from origin_tpu.core import vstack as jvstack
    from origin_tpu_torch.core import Table, join, vstack

    cols = dict(ID=np.array([3, 1, 2]), x=np.array([0.5, 1.5, 2.5]))
    more = dict(ID=np.array([4]), y=np.array([7], np.int32))
    right = dict(ID=np.array([2, 3, 9]), flux=np.array([10.0, 20.0, 30.0]))
    for got, ref in (
            (vstack([Table(cols), Table(more), Table()]),
             jvstack([JTable(cols), JTable(more), JTable()])),
            (join(Table(cols), Table(right)),
             jjoin(JTable(cols), JTable(right)))):
        assert got.colnames == ref.colnames
        for name in got.colnames:
            a, b = np.asarray(got[name]), np.asarray(ref[name])
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_native_fof_gives_the_same_groups():
    from origin_tpu import native as jnative
    from origin_tpu_torch import native
    from origin_tpu_torch.detect.merging import _merge_groups_py

    rng = np.random.default_rng(3)
    x, y = rng.uniform(0, 40, 300), rng.uniform(0, 40, 300)
    z = rng.uniform(0, 500, 300)
    ours = native.fof_merge_groups(x, y, z, 3.0, 7.0)
    assert ours is not None, "the port's native FoF did not build"
    assert str(native.BUILD_DIR) in native.get_lib()._name
    np.testing.assert_array_equal(ours,
                                  jnative.fof_merge_groups(x, y, z, 3.0, 7.0))
    np.testing.assert_array_equal(ours, _merge_groups_py(x, y, z, 3.0, 7.0))


@pytest.mark.parametrize("which", ["minicube", "field"])
def test_synthetic_cubes_are_bit_identical(which, tmp_path):
    from make_minicube import make_minicube as jmini
    from tools_torch import synthetic

    if which == "minicube":
        ours = synthetic.make_minicube(nz=60, ny=20, nx=24)
        ref = jmini(nz=60, ny=20, nx=24)
    else:
        bench = _load_bench_e2e()
        ours, lines = synthetic.make_field(200, 30, 40, seed=7, n_cont=3,
                                           n_faint=4, n_bright=2)
        ref, rlines = bench.make_field(200, 30, 40, seed=7, n_cont=3,
                                       n_faint=4, n_bright=2)
        assert lines == rlines
    for name in ("data", "var"):
        a = np.asarray(getattr(ours, name))
        b = np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    assert list(ours.primary_header.items()) == \
        list(ref.primary_header.items())
    a, b = str(tmp_path / "ours.fits"), str(tmp_path / "ref.fits")
    ours.write(a)
    ref.write(b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def _load_bench_e2e():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench_e2e", os.path.join(REPO, "tools", "bench_e2e.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
