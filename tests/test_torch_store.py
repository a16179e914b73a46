"""The compact session files of the torch port against the JAX package's:
the scaled-int16 encoders, the three file kinds (scaled-int16 images,
sparse scaled-int16 tables, recipes) written by either package and read by
both, the recipe rebuilds, and the parking rules of the compact forms.

Every comparison is bit for bit: the encoders follow the JAX package's
arithmetic step for step (float32 division, round half to even, the
float64 scale of the sparse form), and the recipe rebuilds run the same
numpy code.  The inputs are the minicube's own step-01 and step-05 cubes
(the port's, on the CPU) and seeded edge cases.
"""

import os
import shutil

import numpy as np
import pytest
import torch

from make_minicube import make_minicube
from origin_tpu.core.containers import Cube as JCube
from origin_tpu.core.containers import Quant16 as JQuant16
from origin_tpu.pipeline import recipes as jrecipes
from origin_tpu.pipeline.wires import _encode_i16, _scatter_sparse
from origin_tpu_torch import fitsio
from origin_tpu_torch.core.containers import Cube
from origin_tpu_torch.ops.quant import encode_i16, sparse_i16
from origin_tpu_torch.pipeline import recipes
from origin_tpu_torch.pipeline.products import (
    Parked, TensorCube, _save_cube, stored_form,
)
from origin_tpu_torch.pipeline.session import ORIGIN

torch.set_num_threads(2)

KNOBS = ("ORIGIN_TPU_STORE_RECIPES", "ORIGIN_TPU_STORE_SPARSE",
         "ORIGIN_TPU_STORE_INT16", "ORIGIN_TPU_CORREL_WIRE")
# the ten cube products and the kind each is stored in by default
KINDS = dict(cube_std="recipe:dct_std", cont_dct="recipe:dct_cont",
             cube_faint="recipe:pca_faint", cube_std_local_min="sparse",
             cube_std_local_max="sparse", cube_local_min="sparse",
             cube_local_max="sparse", cube_correl="int16",
             cube_correl_min="int16", cube_profile="uint8")
REAL = ("cube_correl", "cube_correl_min", "cube_local_max", "cube_local_min",
        "cube_std_local_max", "cube_std_local_min")


def file_kind(path):
    """``recipe:<kind>``, ``sparse``, ``int16`` (scaled) or the dtype of a
    dense file."""
    phdr = fitsio.getheader(path, 0)
    if phdr.get("ORITPURE"):
        return "recipe:" + phdr["ORITPURE"]
    if phdr.get("ORITPUSP"):
        return "sparse"
    dhdr = fitsio.getheader(path, 1)
    if int(dhdr["BITPIX"]) == 16 and "BSCALE" in dhdr:
        return "int16"
    return {8: "uint8", -32: "float32"}[int(dhdr["BITPIX"])]


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)


@pytest.fixture(scope="module")
def mini(tmp_path_factory):
    """The port's steps 01-05 on the minicube, written with the defaults;
    the cube products' host copies taken before the write."""
    path = tmp_path_factory.mktemp("store")
    cube_fn = str(path / "minicube.fits")
    make_minicube(cube_fn)
    with pytest.MonkeyPatch.context() as mp:
        for knob in KNOBS:
            mp.delenv(knob, raising=False)
        orig = ORIGIN.init(cube_fn, name="p", path=str(path), device="cpu",
                           loglevel="WARNING")
        orig.step01_preprocessing()
        orig.step02_areas(minsize=30, maxsize=60)
        orig.step03_compute_PCA_threshold()
        orig.step04_compute_greedy_PCA()
        orig.step05_compute_TGLR()
        live = {n: getattr(orig, n).data.copy() for n in KINDS}
        orig.write()
    orig.close_logfile()
    return dict(path=path, cube_fn=cube_fn, folder=orig.outpath, live=live)


def _edge_case(name):
    rng = np.random.default_rng(12)
    if name == "sub_half_step":
        x = np.where(rng.random((40, 6, 7)) < 0.2,
                     rng.standard_normal((40, 6, 7)) * 8, 0)
        x.ravel()[[3, 50, 51, 400]] = [1e-7, -3e-6, 2e-4, -1e-30]
        return x.astype(np.float32)
    if name == "all_zero":
        return np.zeros((9, 4, 5), np.float32)
    shape = dict(odd_7x3x5=(7, 3, 5), odd_1x1x1=(1, 1, 1),
                 odd_300x2x17=(300, 2, 17), odd_1x9x1=(1, 9, 1))[name]
    x = rng.standard_normal(shape) * 3
    return np.where(rng.random(shape) < 0.5, x, 0).astype(np.float32)


EDGES = ("sub_half_step", "all_zero", "odd_7x3x5", "odd_1x1x1",
         "odd_300x2x17", "odd_1x9x1")


@pytest.fixture(params=REAL + EDGES)
def cube_case(request, mini):
    name = request.param
    return mini["live"][name] if name in REAL else _edge_case(name)


# -- codecs ---------------------------------------------------------------
def test_encode_i16_equals_jax(cube_case):
    q, scale = _encode_i16(cube_case)
    tq, tscale = encode_i16(torch.from_numpy(cube_case))
    assert tq.dtype == torch.int16 and tscale == float(scale)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(q))


def test_sparse_i16_equals_jax(cube_case):
    fidx = np.flatnonzero(cube_case).astype(np.int32)
    ref = _scatter_sparse(cube_case.shape, np.float32, fidx.size, fidx,
                          cube_case.ravel()[fidx], quant=True)
    idx, q, scale = sparse_i16(torch.from_numpy(cube_case))
    assert scale == ref.scale
    assert idx.dtype == torch.int32 and q.dtype == torch.int16
    np.testing.assert_array_equal(idx.numpy(), ref.pairs[0])
    np.testing.assert_array_equal(q.numpy(), ref.pairs[1])
    # the +-1 clamp keeps every extremum in the nonzero set
    assert (q != 0).all()


def test_a_kept_scale_gives_back_the_stored_integers():
    """A decoded file re-encoded at its own scale gives its integers again,
    for every int16 value and scales over the whole float32 range that a
    file can hold (the smallest is the all-zero cube's)."""
    q = np.arange(-32767, 32768, dtype=np.int16)
    scales = [1e-30 / 32766, float(np.float32(3.3e-4)), 7.77,
              *10 ** np.random.default_rng(3).uniform(-30, 6, 50)]
    for scale in scales:
        x = q.astype(np.float32) * np.float32(scale)
        got, _ = encode_i16(torch.from_numpy(x[None]), scale=scale)
        np.testing.assert_array_equal(got.numpy()[0], q, err_msg=str(scale))
        _, qs, _ = sparse_i16(torch.from_numpy(x[None]), scale=scale)
        np.testing.assert_array_equal(qs.numpy(), q[q != 0])


# -- files, both ways -----------------------------------------------------
@pytest.mark.parametrize("name", list(KINDS))
def test_port_file_reads_in_jax_as_in_the_port(mini, name):
    path = os.path.join(mini["folder"], name + ".fits")
    assert file_kind(path) == KINDS[name]
    ours = recipes.load_cube(path).data
    theirs = np.asarray(jrecipes.load_cube(path).data)
    assert ours.shape == theirs.shape == mini["live"]["cube_std"].shape
    assert ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)


def _jax_write(kind, live, payload_dir, cube_fn, path):
    """Write ``kind`` with the JAX package's own writers."""
    if kind == "int16":
        q, scale = _encode_i16(live)
        cube = JCube(data=live, mask=False)
        cube._wire16 = JQuant16(np.asarray(q), float(scale))
        cube.write(path)
    elif kind == "sparse":
        fidx = np.flatnonzero(live).astype(np.int32)
        cube = JCube(data=live, mask=False)
        cube._wire16 = _scatter_sparse(live.shape, np.float32, fidx.size,
                                       fidx, live.ravel()[fidx], quant=True)
        cube.write(path)
    elif kind in ("recipe:dct_std", "recipe:dct_cont"):
        hdus = fitsio.read(os.path.join(payload_dir, "cube_std.fits"))
        coef, mean_z = recipes._read_dct_payload(hdus)
        jrecipes.write_dct_recipe(path, kind.split("_")[1], coef, mean_z,
                                  int(hdus[0].header["REORDER"]), cube_fn)
    elif kind == "recipe:pca_faint":
        hdus = fitsio.read(os.path.join(payload_dir, "cube_faint.fits"))
        factors = recipes._read_pca_payload(
            hdus, int(hdus[0].header["RENFACT"]))
        jrecipes.write_pca_recipe(path, factors, cube_fn)
    else:
        JCube(data=live, mask=False).write(path)


@pytest.mark.parametrize("name", list(KINDS))
def test_jax_file_reads_in_the_port_as_in_jax(mini, name, tmp_path):
    folder = tmp_path / "jax"
    folder.mkdir()
    if name == "cube_faint":  # its recipe names cube_std of its folder
        _jax_write("recipe:dct_std", None, mini["folder"], mini["cube_fn"],
                   str(folder / "cube_std.fits"))
    path = str(folder / (name + ".fits"))
    _jax_write(KINDS[name], mini["live"][name], mini["folder"],
               mini["cube_fn"], path)
    assert file_kind(path) == KINDS[name]
    theirs = np.asarray(jrecipes.load_cube(path).data)
    ours = recipes.load_cube(path).data
    assert ours.shape == theirs.shape and ours.dtype == theirs.dtype
    np.testing.assert_array_equal(ours, theirs)
    if not KINDS[name].startswith("recipe"):
        np.testing.assert_array_equal(Cube(path).data, theirs)


# -- recipes --------------------------------------------------------------
def _dct_inputs(seed=4, shape=(120, 9, 11), order=6):
    rng = np.random.default_rng(seed)
    raw = rng.standard_normal(shape).astype(np.float32)
    var = rng.uniform(0.5, 2.0, shape).astype(np.float32)
    mask = rng.random(shape) < 0.02
    var[mask] = np.inf
    coef = rng.standard_normal((order + 1,) + shape[1:]).astype(np.float32)
    mean_z = rng.standard_normal(shape[0]).astype(np.float32) * 0.1
    return raw, var, mask, coef, mean_z, order


def test_rebuild_std_cont_equals_jax():
    args = _dct_inputs()
    for got, want in zip(recipes.rebuild_std_cont(*args),
                         jrecipes.rebuild_std_cont(*args)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_apply_pca_factors_equals_jax():
    rng = np.random.default_rng(5)
    std = rng.standard_normal((80, 10, 12)).astype(np.float32)
    factors = []
    for cols, k in ((np.arange(0, 60), 3), (np.arange(60, 120, 2), 1)):
        factors.append((cols.astype(np.int64),
                        rng.standard_normal((80, k)).astype(np.float32),
                        rng.standard_normal((k, cols.size)).astype(
                            np.float32)))
    got = recipes.apply_pca_factors(std, factors)
    np.testing.assert_array_equal(got, jrecipes.apply_pca_factors(std,
                                                                  factors))
    assert not np.array_equal(got, std)


@pytest.mark.parametrize("name", ("cube_std", "cont_dct", "cube_faint"))
def test_lazy_recipe_windows_equal_the_full_rebuild(mini, name):
    path = os.path.join(mini["folder"], name + ".fits")
    full = recipes.load_cube(path).data
    lazy = recipes.load_cube(path, lazy=True)
    assert isinstance(lazy, recipes.LazyRecipeCube)
    assert lazy.shape == full.shape and lazy.dtype == np.float32
    for win in ((slice(50, 200), slice(5, 20), slice(4, 18)),
                (slice(None), slice(0, 7), slice(53, 60))):
        np.testing.assert_array_equal(lazy[win].data, full[win])
    sub = lazy.subcube((30, 31), 11)
    np.testing.assert_array_equal(sub.data, full[:, 25:36, 26:37])
    # windows never rebuilt the whole cube (nor, for cube_faint, cube_std)
    assert lazy._data_arr is None
    if name == "cube_faint":
        assert lazy._std_source._data_arr is None


def _fork(mini, name):
    src = mini["folder"]
    dst = os.path.join(os.path.dirname(src), name)
    shutil.rmtree(dst, ignore_errors=True)
    return ORIGIN.load(src, newname=name, device="cpu", loglevel="WARNING")


def test_a_fetched_recipe_is_not_rewritten(mini):
    orig = _fork(mini, "refetch")
    path = os.path.join(orig.outpath, "cube_std.fits")
    before = (os.path.getmtime(path), os.path.getsize(path))
    cube = orig.cube_std  # fetched: rebuilt on the host, then uploaded
    assert isinstance(cube, TensorCube) and cube.recipe is not None
    np.testing.assert_array_equal(cube.data,
                                  recipes.load_cube(path).data)
    orig.write()
    assert (os.path.getmtime(path), os.path.getsize(path)) == before
    assert file_kind(path) == "recipe:dct_std"
    orig.close_logfile()


def test_data_assigned_to_a_recipe_product_is_written_dense(mini):
    orig = _fork(mini, "assigned")
    new = orig.cube_std.data * np.float32(2)
    orig.cube_std.data = new
    assert orig.cube_std.recipe is None
    orig.write()
    path = os.path.join(orig.outpath, "cube_std.fits")
    assert file_kind(path) == "float32"
    np.testing.assert_array_equal(Cube(path).data, new)
    np.testing.assert_array_equal(
        np.asarray(jrecipes.load_cube(path).data), new)
    orig.close_logfile()


def test_fetched_products_park_again_in_their_bytes(mini):
    """An erase rewrites every product: the fetched ones (on the session's
    device) and the parked ones (read back to the host) come out as the
    same files, byte for byte, with no second quantization."""
    orig = _fork(mini, "erased")
    saved = {}
    for name in KINDS:
        with open(os.path.join(orig.outpath, name + ".fits"), "rb") as fh:
            saved[name] = fh.read()
    fetched = ("cube_std", "cube_faint", "cube_correl", "cube_local_max",
               "cube_std_local_min", "cube_profile")
    for name in fetched:
        assert isinstance(getattr(orig, name), TensorCube)
    orig.write(erase=True)
    for name in KINDS:
        with open(os.path.join(orig.outpath, name + ".fits"), "rb") as fh:
            assert fh.read() == saved[name], name
        assert isinstance(orig._product_owner[name].store.peek(name),
                          Parked)
    orig.close_logfile()


@pytest.mark.parametrize("knob,value,changed", [
    ("ORIGIN_TPU_STORE_RECIPES", "0",
     dict(cube_std="float32", cont_dct="float32", cube_faint="float32")),
    ("ORIGIN_TPU_STORE_INT16", "0",
     {n: "float32" for n in REAL}),
    ("ORIGIN_TPU_STORE_SPARSE", "0",
     {n: "int16" for n in REAL if "local" in n}),
    ("ORIGIN_TPU_CORREL_WIRE", "f32",
     dict(cube_correl="float32", cube_correl_min="float32")),
])
def test_each_knob_turns_its_forms_off(mini, knob, value, changed,
                                       tmp_path, monkeypatch):
    """The fetched products parked under one knob: the forms it turns off
    are dense, the others as by default, and every file reads back to the
    fetched values."""
    orig = _fork(mini, "knob_" + knob[11:].lower())
    monkeypatch.setenv(knob, value)
    for name, default in KINDS.items():
        cube = getattr(orig, name)
        path = str(tmp_path / (name + ".fits"))
        _save_cube(cube, path)
        assert file_kind(path) == changed.get(name, default), name
        np.testing.assert_array_equal(recipes.load_cube(path).data,
                                      cube.data, err_msg=name)
        np.testing.assert_array_equal(
            np.asarray(jrecipes.load_cube(path).data), cube.data,
            err_msg=name)
    orig.close_logfile()


def test_stored_form_follows_the_knobs(monkeypatch):
    assert [stored_form(f) for f in (None, "int16", "sparse")] == [
        None, "int16", "sparse"]
    monkeypatch.setenv("ORIGIN_TPU_STORE_SPARSE", "0")
    assert stored_form("sparse") == "int16"
    monkeypatch.setenv("ORIGIN_TPU_STORE_INT16", "false")
    assert stored_form("sparse") is stored_form("int16") is None


def test_an_in_memory_cube_session_writes_no_recipe(tmp_path):
    """A recipe is rebuilt from the cube file it names: a session made from
    an in-memory cube stores cube_std and cont_dct dense, as the JAX
    engine does without a cube file; the other forms stay."""
    from tools_torch.synthetic import make_minicube as make_cube

    orig = ORIGIN.init(make_cube(nz=60, ny=12, nx=14), name="mem",
                       path=str(tmp_path), loglevel="WARNING", device="cpu")
    orig.step01_preprocessing()
    orig.write()
    orig.close_logfile()
    kinds = {n: file_kind(str(tmp_path / "mem" / (n + ".fits")))
             for n in ("cube_std", "cont_dct", "cube_std_local_max",
                       "cube_std_local_min")}
    assert kinds == dict(cube_std="float32", cont_dct="float32",
                         cube_std_local_max="sparse",
                         cube_std_local_min="sparse")
