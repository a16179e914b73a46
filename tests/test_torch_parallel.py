"""The port's multi-device layer (``origin_tpu_torch.parallel`` and
``MeshEngine``) against the JAX package's, run on the 8 virtual CPU
devices of tests/conftest.py, and against the port's single device.

The port's meshes name the CPU in every slot (``devices=["cpu"] * n``).
The rules are tests/test_parallel.py's and tests/test_mosaic.py's:

- the halo exchange, the local extrema of row shards and the LPT slot
  deal are exact;
- the sharded detection's local extrema at atol 2e-3 / rtol 1e-3 and its
  counts within 2 voxels per threshold (each tile's spatial stage has its
  own DFT grid); ``glr_tile`` against the JAX ``glr_tile`` at atol 1e-4
  and against the port's single device at 2e-3;
- the mesh PCA against the JAX mesh PCA run to its whole power budget
  (tests/jax_full_budget.py): mapO2 and nstop exact, the faint cube at
  1e-5 of its largest value; against the port's own single-device loop bit
  for bit;
- a mesh session against a single-device one and against the JAX mesh
  session: thresO2 at rtol 1e-4, mapO2 agreeing above 0.99, the
  thresholds within 0.05 (correl) / 0.02 (std), and at the single-device
  thresholds the same Cat0 / Cat1 keyed (x0, y0, z0, comp); fed the
  single device's cube_faint, steps 05-07 agree at 2e-3 (correl, local
  maxima, maxmap, Cat1's T_GLR) with the profiles above 0.999; the source
  files at 2e-3 of each spectrum's largest magnitude.
"""

import glob
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from jax_full_budget import jax_full_budget
from make_minicube import make_minicube, make_segmap
from origin_tpu.core import MoffatFSF, gaussian_profile
from origin_tpu.ops.glr import pack_profiles_toeplitz, prepare_profiles
from origin_tpu.parallel import mesh as jmesh
from origin_tpu.parallel import pca as jpca
from origin_tpu_torch.ops import glr as tglr
from origin_tpu_torch.ops.convolve import fft2_shape
from origin_tpu_torch.ops.localmax import local_maxima
from origin_tpu_torch.parallel import (
    ShardedPipeline, build_tile_spatial_op, glr_tile, greedy_pca_mesh,
    halo_exchange_rows, make_mesh, sharded_detect,
)
from origin_tpu_torch.parallel.mesh import RowShards, _local_max_sharded
from origin_tpu_torch.parallel.pca import balance_slots

torch.set_num_threads(2)

ROW = P(None, "sp", None)


def cpu_mesh(n, dp=1):
    return make_mesh(n, dp=dp, devices=["cpu"] * n)


def rows(a, n):
    return RowShards.split(torch.as_tensor(np.asarray(a)), ["cpu"] * n)


@pytest.fixture(scope="module")
def problem():
    """tests/test_parallel.py's problem: 60 x 32 x 20, 7 x 7 FSF."""
    rng = np.random.default_rng(5)
    nz, ny, nx = 60, 32, 20
    cube = rng.normal(size=(nz, ny, nx)).astype(np.float32)
    var = rng.uniform(0.5, 1.5, size=(nz, ny, nx)).astype(np.float32)
    mask = np.zeros((nz, ny, nx), dtype=bool)
    fsf = MoffatFSF(fwhm_pol=[0.6], beta_pol=[2.8], pixstep=0.2)
    psf = fsf.get_3darray(np.linspace(5000, 9000, nz), (7, 7)).astype(
        np.float32)
    profiles = [gaussian_profile(f, 41, 20) for f in (2.0, 6.0)]
    return cube, var, mask, psf, profiles


# -- the mesh and the row shards ---------------------------------------------
def test_make_mesh_is_explicit():
    mesh = cpu_mesh(8, dp=2)
    assert mesh.shape == {"dp": 2, "sp": 4}
    assert mesh.distinct == [torch.device("cpu")]
    assert len(mesh.row(1)) == 4
    if not torch.cuda.is_available():
        # no device list: CUDA only, never the CPU on its own
        with pytest.raises(RuntimeError, match="CUDA devices requested"):
            make_mesh(4)


@pytest.mark.parametrize("sp,halo", [(4, 0), (4, 1), (4, 2), (1, 2)])
def test_halo_exchange_rows_matches_jax(sp, halo):
    """tests/test_parallel.py's cases: every padded tile equals the JAX
    function's under ``shard_map``; zeros beyond the outer tiles."""
    x = np.arange(8 * 6, dtype=np.float32).reshape(1, 8, 6) + 1
    mesh = jmesh.make_mesh(sp, dp=1)

    @partial(jax.shard_map, mesh=mesh, in_specs=ROW, out_specs=ROW)
    def fn(t):
        return jmesh.halo_exchange_rows(t, halo, "sp")

    want = np.asarray(fn(jnp.asarray(x)))
    tiles = rows(x, sp)
    got = halo_exchange_rows(tiles, halo)
    np.testing.assert_array_equal(torch.cat(got, dim=-2).numpy(), want)
    if halo == 0:
        assert all(a is b for a, b in zip(got, tiles.shards))
    else:
        assert (got[0][:, :halo] == 0).all() and (got[-1][:, -halo:] == 0
                                                  ).all()


@pytest.mark.parametrize("size", [3, 5])
def test_local_max_sharded_negative_data(size):
    """All-negative data: the halo rows outside the cube are -inf, so the
    row shards' local maxima equal the single device's and the JAX
    function's exactly."""
    rng = np.random.default_rng(9)
    x = rng.normal(-5.0, 1.0, size=(20, 16, 10)).astype(np.float32)
    mask = rng.random(x.shape) < 0.05
    got = _local_max_sharded(rows(x, 4), rows(mask, 4), size).to_host()
    single = local_maxima(torch.from_numpy(x), torch.from_numpy(mask),
                          size).numpy()
    np.testing.assert_array_equal(got, single)

    @partial(jax.shard_map, mesh=jmesh.make_mesh(4, dp=1),
             in_specs=(ROW, ROW), out_specs=ROW)
    def fn(t, m):
        return jmesh._local_max_sharded(t, m, size, "sp")

    np.testing.assert_array_equal(got, np.asarray(fn(x, mask)))
    assert (got < 0).any()


def test_row_shards_read_windows_across_tiles():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 12, 5)).astype(np.float32)
    r = rows(x, 4)
    assert tuple(r.shape) == x.shape and r.row_start(2) == 6
    for y0, y1 in ((0, 12), (2, 7), (5, 6), (-3, 4), (10, 20)):
        np.testing.assert_array_equal(r.rows(y0, y1).numpy(),
                                      x[:, max(0, y0):min(12, y1)])
    np.testing.assert_array_equal(RowShards.from_host(x, cpu_mesh(3))
                                  .to_host(), x)


def test_encoders_on_row_shards_equal_the_whole_cube():
    """A mesh session writes its int16 and sparse files from the tiles:
    the integers, indices and scales of the whole cube's encoding."""
    from origin_tpu_torch.ops.quant import encode_i16, sparse_i16

    rng = np.random.default_rng(6)
    x = rng.normal(size=(30, 16, 10)).astype(np.float32)
    x[rng.random(x.shape) < 0.9] = 0.0  # sparse, as local extrema are
    whole, tiles = torch.from_numpy(x), rows(x, 4)
    for a, b in zip(tiles.encode_i16(), encode_i16(whole)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(tiles.sparse_i16(), sparse_i16(whole)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tiles.sparse_i16()[0].dtype == torch.int32


# -- the sharded detection ---------------------------------------------------
@pytest.mark.parametrize("fsf", ["square", "nonsquare", "masked"])
def test_sharded_detect_matches_jax(problem, fsf):
    """8 row shards against the JAX package's 8 devices; the non-square
    FSF (ph > pw) sizes the halo from its y extent; masked voxels (filled
    as a field's ingest fills them) take the JAX tile kernel's unit DCT
    weight."""
    cube, var, mask, psf, profiles = problem
    if fsf == "nonsquare":
        psf = np.ascontiguousarray(psf[:, :, 1:-1])
    elif fsf == "masked":
        mask = np.random.default_rng(8).random(cube.shape) < 0.01
        mask[:, 3, 4] = True
        cube = np.where(mask, 0.0, cube).astype(np.float32)
        var = np.where(mask, np.inf, var).astype(np.float32)
    th = np.linspace(1.0, 8.0, 20).astype(np.float32)
    lmax, lmin, cmax, cmin = sharded_detect(
        cpu_mesh(8), cube, var, mask, psf, profiles, thresholds=th)
    jmax, jmin, jcmax, jcmin = jmesh.sharded_detect(
        jmesh.make_mesh(8, dp=1), cube, var, mask, psf, profiles,
        thresholds=th)
    np.testing.assert_allclose(lmax, jmax, atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(lmin, jmin, atol=2e-3, rtol=1e-3)
    assert np.abs(cmax - np.asarray(jcmax)).max() <= 2
    assert np.abs(cmin - np.asarray(jcmin)).max() <= 2
    assert cmax[0] > 0


def test_sharded_batch_dp_sp(problem):
    """dp=2 x sp=4: each element against the JAX batch, and the dp
    elements independent (swapping them swaps the outputs bit for bit)."""
    cube, var, mask, psf, profiles = problem
    cubes = np.stack([cube, cube * 1.1])
    variances, masks = np.stack([var, var]), np.stack([mask, mask])
    pipe = ShardedPipeline(cpu_mesh(8, dp=2), *cube.shape, psf, profiles)
    lmax, lmin, cmax, cmin = pipe(cubes, variances, masks)
    jpipe = jmesh.ShardedPipeline(jmesh.make_mesh(8, dp=2), *cube.shape,
                                  psf, profiles)
    jmax, _, jcmax, _ = jpipe(cubes, variances, masks)
    got = np.stack([t.to_host() for t in lmax])
    assert got.shape == cubes.shape and cmax.shape[0] == 2
    np.testing.assert_allclose(got, np.asarray(jmax), atol=2e-3, rtol=1e-3)
    assert np.abs(cmax - np.asarray(jcmax)).max() <= 2
    sw, _, cmax_sw, _ = pipe(cubes[::-1], variances[::-1], masks[::-1])
    np.testing.assert_array_equal(got[0], sw[1].to_host())
    np.testing.assert_array_equal(got[1], sw[0].to_host())
    np.testing.assert_array_equal(cmax, cmax_sw[::-1])
    assert not np.array_equal(got[0], got[1])


def test_glr_tile_mosaic_matches_jax_and_single_device(problem):
    """Two fields with overlapping weight maps: the port's tiles against
    the JAX ``glr_tile`` under ``shard_map`` (its XLA sweep) and against
    the port's single-device spatial stage and sweep."""
    cube, _, mask, psf, profiles = problem
    nz, ny, nx = cube.shape
    psf2 = MoffatFSF(fwhm_pol=[0.8], beta_pol=[2.5], pixstep=0.2
                     ).get_3darray(np.linspace(5000, 9000, nz), (7, 7)
                                   ).astype(np.float32)
    ramp = np.clip((np.arange(nx) - nx / 2) / 6 + 0.5, 0, 1)
    w2 = np.broadcast_to(ramp, (ny, nx)).astype(np.float32)
    wtiles = np.stack([1.0 - w2, w2])
    t_num, t_den, pad_left, _ = pack_profiles_toeplitz(
        prepare_profiles(profiles), block=min(128, nz))
    ops, jops = [], []
    for pf in (psf, psf2):
        op, halo = build_tile_spatial_op(pf, ny // 8, nx)
        jop, jhalo = jmesh.build_tile_spatial_op(pf, ny // 8, nx)
        assert halo == jhalo
        for k in ("kern_r", "kern_i", "kern2_r", "kern2_i"):
            # torch's float64 FFT on the mesh's device against the JAX
            # package's host numpy (the zero-mean kernel differs by
            # float32 order)
            np.testing.assert_allclose(op[k].numpy(), jop[k],
                                       atol=1e-6 * np.abs(jop[k]).max())
        for k, v in op["factors"].items():
            np.testing.assert_array_equal(v, jop["factors"][k])
        ops.append(op)
        jops.append(jop)
    got = glr_tile(rows(cube, 8), rows(mask, 8), ops, t_num, t_den,
                   pad_left, nz, halo=halo, wtiles=rows(wtiles, 8))
    got = [g.to_host() for g in got]

    op_spec = jax.tree.map(lambda _: P(), jops)

    @partial(jax.shard_map, mesh=jmesh.make_mesh(8, dp=1),
             in_specs=(ROW, ROW, op_spec, P(), P(), ROW),
             out_specs=(ROW,) * 5 + (P("sp", None),) * 2)
    def prog(f, m, o, tn, td, wt):
        return jmesh.glr_tile(f, m, o, tn, td, pad_left, nz, halo=halo,
                              wtiles=wt)

    want = jax.jit(prog)(cube, mask, jax.tree.map(jnp.asarray, jops),
                         t_num, t_den, wtiles)
    names = ("correl", "correl_min", "profile", "lmax", "lmin", "maxmap",
             "minmap")
    for name, a, b in zip(names, got, want):
        if name == "profile":
            assert np.mean(a == np.asarray(b)) > 0.999
        else:
            np.testing.assert_allclose(a, np.asarray(b), atol=1e-4,
                                       err_msg=name)

    # the single device: the spectra bank and the whole-cube matmul chain
    psfs = torch.from_numpy(np.stack([psf, psf2]))
    wm = torch.from_numpy(wtiles)
    fshape2 = fft2_shape((ny, nx), (7, 7))
    kern, norm = tglr.precompute_spatial(psfs, wm, ny, nx, fshape2)
    factors = {k: torch.from_numpy(v) for k, v in
               tglr.dft_spatial_factors(ny, nx, fshape2, (7, 7)).items()}
    fsf = tglr.glr_spatial_matmul(torch.from_numpy(cube), kern.real,
                                  kern.imag, wm, factors)
    correl, _, _ = tglr.toeplitz_sweep(fsf, norm, torch.from_numpy(t_num),
                                       torch.from_numpy(t_den), pad_left, nz)
    np.testing.assert_allclose(got[0], correl.numpy(), atol=2e-3, rtol=1e-3)


# -- the area-parallel PCA ---------------------------------------------------
@pytest.mark.parametrize("sizes", [
    [4000, 3900] + [100] * 14,
    [7, 300, 12, 300, 5, 900, 40, 41],
    list(np.random.default_rng(4).integers(1, 5000, 23)),
])
def test_balance_slots_equals_jax(sizes):
    sp = 8
    m = -(-len(sizes) // sp)
    slots = balance_slots(sizes, sp, m)
    np.testing.assert_array_equal(slots, jpca.balance_slots(sizes, sp, m))
    assert len(set(slots.tolist())) == len(sizes)  # one area a slot


def _pca_case(which):
    """tests/test_parallel.py's two PCA cases: 3 areas, or 16 skewed."""
    if which == "three":
        rng = np.random.default_rng(3)
        nz, ny, nx, pct = 80, 32, 24, 85
        areamap = np.zeros((ny, nx), int)
        areamap[:16, :] = 1
        areamap[16:, :12] = 2
        areamap[16:, 12:] = 3
        nsel = 60
    else:
        rng = np.random.default_rng(11)
        nz, ny, nx, pct = 60, 32, 32, 80
        areamap = np.zeros((ny, nx), int)
        areamap[:, :16] = 1
        label = 2
        for by in range(0, 32, 8):
            for bx in range(16, 32, 4):
                areamap[by:by + 8, bx:bx + 4] = label
                label += 1
        nsel = 120
    cube = rng.normal(size=(nz, ny, nx)).astype(np.float32)
    sel = rng.choice(ny * nx, nsel, replace=False)
    cube.reshape(nz, -1)[:, sel] *= 4.0
    o2 = np.mean(cube.astype(np.float64) ** 2, axis=0)
    testO2, thr = [], []
    for a in range(1, areamap.max() + 1):
        t = o2[areamap == a]
        testO2.append(t)
        thr.append(np.percentile(t, pct))
    return cube, areamap, thr, testO2


@pytest.mark.parametrize("which", ["three", "skewed"])
def test_greedy_pca_mesh_matches_jax_and_single_device(which):
    from origin_tpu_torch.pipeline.engine import TorchEngine

    cube, areamap, thr, testO2 = _pca_case(which)
    faint, mapo2, nstop = greedy_pca_mesh(cpu_mesh(8), rows(cube, 8),
                                          areamap, thr, testO2)
    faint = faint.to_host()
    with jax_full_budget():
        jfaint, jmap, jstop = jpca.greedy_pca_mesh(
            jmesh.make_mesh(8, dp=1), jnp.asarray(cube), areamap, thr,
            testO2)
    assert nstop == jstop
    np.testing.assert_array_equal(mapo2, jmap)
    assert mapo2.max() >= 2  # the case iterates
    scale = np.abs(cube).max()
    np.testing.assert_allclose(faint, np.asarray(jfaint), atol=1e-5 * scale)

    # the port's single-device area loop, on the same cube_std
    eng = TorchEngine.__new__(TorchEngine)
    eng.device = torch.device("cpu")
    eng.get = lambda name: torch.from_numpy(cube)
    f1, m1, s1, _ = eng.greedy_pca_by_area(areamap, thr, testO2)
    assert s1 == nstop
    np.testing.assert_array_equal(m1, mapo2)
    np.testing.assert_array_equal(f1.numpy(), faint)


# -- sessions ----------------------------------------------------------------
def test_mesh_engine_validation(tmp_path):
    """A bad mesh fails at session construction, with the JAX errors."""
    from types import SimpleNamespace

    from origin_tpu_torch.pipeline.session import ORIGIN

    cube_fn = str(tmp_path / "m.fits")
    make_minicube(cube_fn, nz=80, ny=30, nx=24)
    kw = dict(path=str(tmp_path), loglevel="ERROR", device="cpu")
    with pytest.raises(ValueError, match="divide"):
        ORIGIN.init(cube_fn, name="bad1", mesh=cpu_mesh(8), **kw)
    with pytest.raises(ValueError, match="dp batches"):
        ORIGIN.init(cube_fn, name="bad2", mesh=cpu_mesh(8, dp=2), **kw)
    with pytest.raises(ValueError, match="'sp' axis"):
        ORIGIN.init(cube_fn, name="bad3",
                    mesh=SimpleNamespace(shape={"dp": 1, "x": 2}), **kw)
    # the mesh's slots lie on the session's device type
    with pytest.raises((ValueError, RuntimeError), match="cuda"):
        ORIGIN.init(cube_fn, name="bad4", mesh=cpu_mesh(2),
                    **dict(kw, device="cuda"))
    ok = ORIGIN.init(cube_fn, name="ok", mesh=cpu_mesh(2), **kw)
    # one device under the two slots: the memory is not divided
    assert ok.engine.memory_shards == 1
    ok.close_logfile()


def _keyed(cat):
    return sorted(zip(*(np.asarray(cat[k]).tolist()
                        for k in ("x0", "y0", "z0", "comp"))))


@pytest.fixture(scope="module")
def minicube(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh_session")
    cube_fn, seg_fn = str(path / "mini.fits"), str(path / "seg.fits")
    make_minicube(cube_fn, nz=400, ny=64, nx=64)
    make_segmap(seg_fn, ny=64, nx=64)
    return path, cube_fn, seg_fn


def _front(orig):
    orig.step01_preprocessing()
    orig.step02_areas(minsize=20, maxsize=40)
    orig.step03_compute_PCA_threshold()
    orig.step04_compute_greedy_PCA()
    orig.step05_compute_TGLR(ncpu=1)
    orig.step06_compute_purity_threshold(purity=0.8)
    return orig


@pytest.fixture(scope="module")
def sessions(minicube):
    """The minicube's steps 01-06 on the port's single device, on an
    8-slot port mesh and on the JAX package's 8-device mesh (its power
    iteration run to its whole budget); steps 07 of each at the single
    device's thresholds."""
    from origin_tpu import ORIGIN as JORIGIN
    from origin_tpu_torch.pipeline.session import ORIGIN

    path, cube_fn, seg_fn = minicube
    kw = dict(path=str(path), loglevel="WARNING", PSF_size=9)
    ref = _front(ORIGIN.init(cube_fn, name="single", device="cpu", **kw))
    shd = _front(ORIGIN.init(cube_fn, name="meshed", device="cpu",
                             mesh=cpu_mesh(8), **kw))
    with jax_full_budget():
        jax_shd = _front(JORIGIN.init(cube_fn, name="jaxmesh",
                                      mesh=jmesh.make_mesh(8, dp=1), **kw))
        thr = ref.param["threshold"], ref.param["threshold_std"]
        for o in (ref, shd, jax_shd):
            o.step07_detection(threshold=thr[0], threshold_std=thr[1],
                               segmap=seg_fn)
        jax_shd.write()
    yield dict(ref=ref, shd=shd, jax=jax_shd, thr=thr, path=path,
               seg_fn=seg_fn)
    for o in (ref, shd, jax_shd):
        o.close_logfile()


def test_mesh_session_matches_single_device_and_jax(sessions):
    from origin_tpu_torch.pipeline.engine import MeshEngine
    from origin_tpu_torch.pipeline.products import TensorCube

    ref, shd, jax_shd = sessions["ref"], sessions["shd"], sessions["jax"]
    assert isinstance(shd.engine, MeshEngine)
    faint = shd.steps["compute_greedy_PCA"].store.peek("cube_faint")
    assert isinstance(faint, TensorCube) and isinstance(faint.tensor,
                                                        RowShards)
    assert len(faint.tensor.shards) == 8
    assert ref.param["nbareas"] == shd.param["nbareas"] >= 2
    for other in (ref, jax_shd):
        np.testing.assert_allclose(np.asarray(shd.thresO2),
                                   np.asarray(other.thresO2), rtol=1e-4)
        same = np.mean(shd.mapO2.data == other.mapO2.data)
        assert same > 0.99, f"mapO2 agreement {same:.4f}"
        assert shd.param["threshold"] == pytest.approx(
            other.param["threshold"], abs=0.05)
        assert shd.param["threshold_std"] == pytest.approx(
            other.param["threshold_std"], abs=0.02)
        assert _keyed(shd.Cat0) == _keyed(other.Cat0)
        assert _keyed(shd.Cat1) == _keyed(other.Cat1)
    assert len(shd.Cat1) > 0
    np.testing.assert_array_equal(np.sort(np.asarray(shd.Cat1["ID"])),
                                  np.sort(np.asarray(ref.Cat1["ID"])))


def test_mesh_session_pinned_to_single_device_faint(sessions):
    """Steps 05-07 of a mesh session fed the single device's cube_faint."""
    from origin_tpu_torch.pipeline.session import ORIGIN

    ref, path = sessions["ref"], sessions["path"]
    thr, thr_std = sessions["thr"]
    pin = ORIGIN.init(ref.param["cubename"], name="pinned", device="cpu",
                      path=str(path), loglevel="WARNING", PSF_size=9,
                      mesh=cpu_mesh(8))
    pin.step01_preprocessing()
    pin.step02_areas(minsize=20, maxsize=40)
    pin.step03_compute_PCA_threshold()
    pin.engine.load_state({"cube_faint": ref.cube_faint.data})
    pin.step05_compute_TGLR(ncpu=1)
    for name in ("cube_correl", "cube_local_max"):
        np.testing.assert_allclose(getattr(pin, name).data,
                                   getattr(ref, name).data, atol=2e-3,
                                   rtol=1e-3, err_msg=name)
    np.testing.assert_allclose(pin.maxmap.data, ref.maxmap.data, atol=2e-3,
                               rtol=1e-3)
    same = np.mean(pin.cube_profile.data == ref.cube_profile.data)
    assert same > 0.999, f"profile agreement {same:.5f}"
    pin.step06_compute_purity_threshold(purity=0.8)
    assert pin.param["threshold"] == pytest.approx(thr, abs=0.02)
    pin.step07_detection(threshold=thr, threshold_std=thr_std,
                         segmap=sessions["seg_fn"])
    assert _keyed(pin.Cat0) == _keyed(ref.Cat0)
    assert _keyed(pin.Cat1) == _keyed(ref.Cat1)

    def tglr_by_position(cat):
        order = np.lexsort((np.asarray(cat["z0"]), np.asarray(cat["y0"]),
                            np.asarray(cat["x0"])))
        return np.asarray(cat["T_GLR"], float)[order]

    a, b = tglr_by_position(pin.Cat1), tglr_by_position(ref.Cat1)
    finite = np.isfinite(b)
    np.testing.assert_allclose(a[finite], b[finite], atol=2e-3)
    pin.close_logfile()


def test_mesh_session_resumes_and_writes_sources(sessions):
    """The mesh session written, loaded with ``mesh=``, steps 07-11: the
    files are the JAX mesh session's kinds (cube_faint dense, no recipe),
    Cat1 is the written session's, and the source files match the
    single device's."""
    from origin_tpu_torch.artifacts.source import Source
    from origin_tpu_torch.pipeline.engine import MeshEngine
    from origin_tpu_torch.pipeline.recipes import is_recipe_file
    from origin_tpu_torch.pipeline.session import ORIGIN

    ref, shd, path = sessions["ref"], sessions["shd"], sessions["path"]
    thr, thr_std = sessions["thr"]
    shd.write()
    for name, recipe in (("cube_faint", False), ("cube_std", True)):
        for folder in ("meshed", "jaxmesh"):
            fn = str(path / folder / (name + ".fits"))
            assert bool(is_recipe_file(fn)) is recipe, (folder, name)
    res = ORIGIN.load(str(path / "meshed"), device="cpu", mesh=cpu_mesh(8),
                      loglevel="WARNING")
    assert isinstance(res.engine, MeshEngine)
    res.step07_detection(threshold=thr, threshold_std=thr_std,
                         segmap=sessions["seg_fn"])
    assert _keyed(res.Cat1) == _keyed(shd.Cat1)
    for o in (res, ref):
        o.step08_compute_spectra()
        o.step09_clean_results()
        o.step10_create_masks()
        o.step11_save_sources("0.1")
    assert len(res.Cat2) == len(res.Cat1)
    nsrc = len(np.unique(np.asarray(res.Cat3_lines["ID"])))
    files = sorted(glob.glob(str(path / "meshed" / "sources"
                                 / "source-*.fits")))
    assert len(files) == nsrc == len(glob.glob(
        str(path / "single" / "sources" / "source-*.fits")))
    checked = 0
    for fn in files:
        a = Source.from_file(fn)
        b = Source.from_file(str(path / "single" / "sources"
                                 / os.path.basename(fn)))
        assert set(a.spectra) == set(b.spectra)
        for tag in a.spectra:
            sa, sb = a.spectra[tag], b.spectra[tag]
            scale = max(1.0, float(np.nanmax(np.abs(sb.data))))
            np.testing.assert_allclose(np.asarray(sa.data),
                                       np.asarray(sb.data),
                                       atol=2e-3 * scale,
                                       err_msg=f"{fn} {tag}")
            checked += 1
    assert checked > 5
    res.close_logfile()


@pytest.fixture(scope="module")
def mosaic_cube(tmp_path_factory):
    """tests/test_mosaic.py's two-field mosaic."""
    from origin_tpu.core import Image

    path = tmp_path_factory.mktemp("mesh_mosaic")
    cube_fn = str(path / "mosaic.fits")
    cube = make_minicube(nz=200, ny=40, nx=40)
    hdr = cube.primary_header
    for key in list(hdr.keys()):
        if key.startswith("FSF") and key not in ("FSFMODE", "FSFLB1",
                                                 "FSFLB2"):
            del hdr[key]
    MoffatFSF(fwhm_pol=[0.7], beta_pol=[2.8], field=0).to_header(hdr)
    MoffatFSF(fwhm_pol=[0.6], beta_pol=[2.6], field=1).to_header(hdr)
    cube.write(cube_fn)
    fmap = np.zeros((40, 40), dtype=np.int64)
    fmap[:, :20] = 1
    fmap[:, 20:] = 2
    fmap_fn = str(path / "fieldmap.fits")
    Image(data=fmap).write(fmap_fn)
    return path, cube_fn, fmap_fn


def test_mosaic_on_mesh_matches_single_device(mosaic_cube):
    """tests/test_mosaic.py's mosaic on a 4-slot mesh (ny 40 / 4 = 10 >=
    halo 6): Cat1 at the single device's thresholds, and the correl cube
    within 2e-2 at its 99.9th percentile."""
    from origin_tpu_torch.pipeline.session import ORIGIN

    path, cube_fn, fmap_fn = mosaic_cube

    def run(name, mesh):
        orig = ORIGIN.init(cube_fn, fieldmap=fmap_fn, name=name,
                           path=str(path), loglevel="WARNING", PSF_size=13,
                           device="cpu", mesh=mesh)
        orig.step01_preprocessing()
        orig.step02_areas()
        orig.step03_compute_PCA_threshold()
        orig.step04_compute_greedy_PCA()
        orig.step05_compute_TGLR()
        orig.step06_compute_purity_threshold(purity=0.8)
        return orig

    ref = run("mosref", None)
    shd = run("mosmesh", cpu_mesh(4))
    assert shd.wfields is not None and len(shd.wfields) == 2
    thr, thr_std = ref.param["threshold"], ref.param["threshold_std"]
    for o in (ref, shd):
        o.step07_detection(threshold=thr, threshold_std=thr_std)
    assert len(ref.Cat1) > 0
    assert _keyed(shd.Cat1) == _keyed(ref.Cat1)
    d = np.abs(shd.cube_correl.data - ref.cube_correl.data)
    assert np.percentile(d, 99.9) < 2e-2
    for o in (ref, shd):
        o.close_logfile()
