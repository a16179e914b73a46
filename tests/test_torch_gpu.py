"""CUDA tests of origin_tpu_torch: they need an NVIDIA GPU and skip without
one.  The file imports nothing of JAX, so it also runs where JAX is not
installed, with the repository's conftest (which imports JAX) left out:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: the kernel and the plain sweep sum the profile taps in
different orders, so correl and correl_min agree at atol 1e-5 + rtol
1e-5, and the best-profile index may differ only where the two candidate
profiles' statistics are within 1e-5 of each other.  The sweep cases also
hold a NaN sample and den = 0 and den < 0 spaxels (see ``_hold`` for what
the NaN may change).  The bf16x3 sweep kernel's split is shown as the
spatial kernel's is, by the RMS rule below.  The spatial kernel
sums its products in 64 x 64 tiles, cuBLAS in its own order: atol 1e-5 on
values of order 1 in both precisions (in bf16x3 a one-ulp difference of a
float32 intermediate can also move a split's low half by one bf16 step; the
largest reading on an H100 is 4.65e-6).  bf16x3 and ``highest`` differ by
about as much at their largest, so the split itself is shown by RMS
distances: the bf16x3 kernel lies at least 4 times the ``highest`` kernel's
float32 order noise away from the ``highest`` kernel, and at least 1.5
times nearer its own plain version (a one-ulp change upstream moves a split
by a bf16 step, so the two bf16x3 forms part by about half the gap).
"""

import gc

import numpy as np
import pytest
import torch

import lines_cases
import sources_cases
from origin_tpu_torch.core import MoffatFSF
from origin_tpu_torch.core.profiles import (
    DICO_3FWHM, DICO_FWHM_2_12, default_dictionary_path, load_dictionary,
)
from origin_tpu_torch.ops import (
    cutouts, glr, kernels, lines, spatial, spectra,
)
from origin_tpu_torch.ops.convolve import fft2_shape
from origin_tpu_torch.ops.prec import split_bf16
from origin_tpu_torch.ops.spatial import spatial_fsf
from origin_tpu_torch.ops.sweep import (
    spectral_sweep, sweep_taps, toeplitz_blocks,
)

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


# hand-made profiles of these lengths (centre (len - 1) // 2, random taps):
# spans shorter than a thread's 8 channels and not multiples of them, and
# more than 255 profiles (int32 indices); the longest spans the whole
# reach, as in the dictionaries
HAND_BANKS = dict(short_spans=[1, 2, 3, 5, 7, 9, 13, 17, 21],
                  k260=[1 + (5 * k) % 21 for k in range(260)])
DICOS = [DICO_3FWHM, DICO_FWHM_2_12, *HAND_BANKS]
# nz of 1, RZ -+ 1 and TZ -+ 1 of the float32 kernel's tile (8 channels a
# thread, 64 a block, in both layouts), twice those, and others; spaxel
# counts of 15, 49 and 600 leave a partial warp.  The bf16x3 kernel's tile
# is 64 channels x 32 spaxels, its float4 loads need S % 4 == 0: odd
# spaxel counts off every multiple of 32 (63, 65, 187) at nz 64 -+ 1 and
# 200 take its scalar loads, 36 and 600 its float4 loads with a ragged last
# tile
SWEEP_SHAPES = [(700, 20, 30), (77, 3, 5), (1, 3, 5), (7, 3, 5), (9, 3, 5),
                (15, 3, 5), (17, 3, 5), (63, 3, 5), (65, 3, 5), (127, 3, 5),
                (129, 7, 7), (63, 7, 9), (65, 7, 9), (63, 5, 13),
                (65, 5, 13), (200, 11, 17), (130, 4, 9)]


def _profiles(dico, rng):
    """(profile, centre) pairs of a dictionary or of a hand-made bank, the
    latter drawn from ``rng``."""
    if dico in HAND_BANKS:
        return [(p, (len(p) - 1) // 2) for p in
                (rng.normal(size=m) for m in HAND_BANKS[dico])]
    profiles, _ = load_dictionary(default_dictionary_path(dico))
    return glr.prepare_profiles(profiles)


def _problem(dico, nz, ny, nx, dev, seed=6, nan=False):
    """Cubes and banks; den = 0 at spaxel (0, 0); with ``nan``, den < 0 at
    spaxel (0, 1) and one NaN sample of x at spaxel (0, 2)."""
    rng = np.random.default_rng(seed)
    prepped = _profiles(dico, rng)
    t_num, t_den, pad_left, _ = glr.pack_profiles_toeplitz(
        prepped, block=min(128, nz))
    x = rng.normal(size=(nz, ny, nx)).astype(np.float32)
    n = rng.uniform(0.5, 2.0, size=(nz, ny, nx)).astype(np.float32)
    n[:, 0, 0] = 0.0  # the den <= 0 guard
    if nan:
        n[:, 0, 1] = -1.0
        x[nz // 2, 0, 2] = np.nan
    return [torch.from_numpy(a).to(dev) for a in (x, n, t_num, t_den)], \
        pad_left


def _dot64(a, taps, precision):
    """``sum(a * taps)`` in float64 of the products the kernel forms: the
    float32 operands, or the three bf16x3 passes."""
    if precision != "bf16x3":
        return float((a.double() * taps.double()).sum())
    (ah, al), (th, tl) = (tuple(v.double() for v in split_bf16(u))
                          for u in (a, taps))
    return float((ah * th + al * th + ah * tl).sum())


def _assert_ties(p, pr, x, n, t_num, t_den, pad_left, precision="highest"):
    """(Nz, Ny, Nx) index cubes equal except at near-ties of the
    statistic that both sides compute at ``precision``."""
    bad = (p != pr).nonzero()
    if bad.numel():
        taps_num, taps_den, _, _ = sweep_taps(t_num, t_den)
        xs = torch.nn.functional.pad(x, (0, 0, 0, 0, pad_left,
                                         taps_num.shape[1]))
        ns = torch.nn.functional.pad(n, (0, 0, 0, 0, pad_left,
                                         taps_num.shape[1]))
        for z, yy, xx in bad.tolist():
            win_x = xs[z:z + taps_num.shape[1], yy, xx]
            win_n = ns[z:z + taps_num.shape[1], yy, xx]
            t = [_dot64(win_x, taps_num[k], precision)
                 / _dot64(win_n, taps_den[k], precision) ** 0.5
                 for k in (int(p[z, yy, xx]), int(pr[z, yy, xx]))]
            assert abs(t[0] - t[1]) <= 1e-5


def _nan_regions(x, t_num, t_den, pad_left):
    """Boolean cubes of the voxels whose NaN sample of x lies in their
    reach, in every profile's span, in the (W, block) window of their
    block in the banks, and in a 16 x 16 block of some profile's band over
    their 16-channel group.  The banded plain version multiplies a NaN by
    the zero taps of its whole window, the float32 kernel only within each
    profile's span, the bf16x3 kernel within the blocks of each profile's
    k-step range (``ops/sweep.py:spectral_sweep``)."""
    nprof, window, block = t_num.shape
    taps_num, _, start, length = sweep_taps(t_num, t_den)
    _, d_first, d_last = toeplitz_blocks(taps_num, start, length)
    reach = window - block + 1
    regions = [torch.zeros(x.shape, dtype=torch.bool, device=x.device)
               for _ in range(4)]
    z = torch.arange(x.shape[0], device=x.device)
    g0 = (z // 16 * 16 - pad_left)[:, None]
    for zn, yy, xx in torch.isnan(x).nonzero().tolist():
        d = zn - z + pad_left
        spans = ((d[:, None] >= start[None, :])
                 & (d[:, None] < (start + length)[None, :]))
        w0 = z // block * block - pad_left
        blocks = ((zn >= g0 + 16 * d_first[None, :])
                  & (zn < g0 + 16 * (d_last[None, :] + 1)))
        for r, m in zip(regions, ((d >= 0) & (d < reach), spans.all(1),
                                 (zn >= w0) & (zn < w0 + window),
                                 blocks.any(1))):
            r[:, yy, xx] |= m
    return regions


def _hold(got, ref, x, n, t_num, t_den, pad_left, precision="highest",
          index_dtype=None):
    """The kernel's (correl, profile, correl_min) against the plain
    version's: values at atol 1e-5 + rtol 1e-5, indices equal but at
    near-ties, of ``index_dtype`` (by default the cube layout's: uint8 up
    to 255 profiles, int32 above).  Where x holds a NaN, the kernel's
    values are NaN exactly in its footprint: the reach at ``highest`` (the
    longest profile spans it), its blocks' window in bf16x3 (which holds
    the reach).  The comparison skips the values where the NaN lies in
    either side's window but outside the reach, and the indices where it
    lies in either window but outside some profile's span."""
    (c, p, m), (cr, pr, mr) = got, ref
    if index_dtype is None:
        wide = t_num.shape[0] > 255
        index_dtype = torch.int32 if wide else torch.uint8
    assert p.dtype == pr.dtype == index_dtype
    assert torch.all(c[:, 0, 0] == 0)
    if torch.isnan(x).any():
        assert torch.all(c[:, 0, 1] == 0)  # den < 0
        in_reach, in_spans, in_window, in_blocks = _nan_regions(
            x, t_num, t_den, pad_left)
        footprint = in_blocks if precision == "bf16x3" else in_reach
        assert not (in_reach & ~footprint).any()
        assert torch.equal(torch.isnan(c), footprint)
        assert torch.equal(torch.isnan(m), footprint)
        either = in_window | footprint
        spread = either & ~in_reach
        c, m = torch.where(spread, cr, c), torch.where(spread, mr, m)
        p = torch.where(either & ~in_spans, pr, p)
    torch.testing.assert_close(c, cr, atol=1e-5, rtol=1e-5, equal_nan=True)
    torch.testing.assert_close(m, mr, atol=1e-5, rtol=1e-5, equal_nan=True)
    _assert_ties(p, pr, x, n, t_num, t_den, pad_left, precision)


@pytest.mark.gpu
@pytest.mark.parametrize("dico", DICOS)
@pytest.mark.parametrize("shape", SWEEP_SHAPES)
def test_cuda_kernel_matches_plain(cuda, dico, shape):
    nz = shape[0]
    (x, n, t_num, t_den), pad_left = _problem(dico, *shape, cuda, nan=True)
    before = spectral_sweep.launches
    got = spectral_sweep(x, n, t_num, t_den, pad_left, nz)
    torch.cuda.synchronize()
    assert spectral_sweep.launches == before + 1
    ref = glr.toeplitz_sweep(x, n, t_num, t_den, pad_left, nz)
    _hold(got, ref, x, n, t_num, t_den, pad_left)


@pytest.mark.gpu
@pytest.mark.parametrize("dico", DICOS)
@pytest.mark.parametrize("shape", SWEEP_SHAPES)
def test_cuda_bf16x3_sweep_matches_plain(cuda, dico, shape):
    nz = shape[0]
    (x, n, t_num, t_den), pad_left = _problem(dico, *shape, cuda, nan=True)
    before = spectral_sweep.launches_bf16x3
    got = spectral_sweep(x, n, t_num, t_den, pad_left, nz,
                         precision="bf16x3")
    torch.cuda.synchronize()
    assert spectral_sweep.launches_bf16x3 == before + 1
    ref = glr.toeplitz_sweep(x, n, t_num, t_den, pad_left, nz,
                             precision="bf16x3")
    _hold(got, ref, x, n, t_num, t_den, pad_left, "bf16x3")


def _spatial_problem(nz, ny, nx, psf, nfields, dev, seed=2):
    rng = np.random.default_rng(seed)
    cube = rng.normal(size=(nz, ny, nx)).astype(np.float32)
    fsf = MoffatFSF(fwhm_pol=[-0.2, 0.7], beta_pol=[2.8], pixstep=0.2)
    one = fsf.get_3darray(4750 + 1.25 * np.arange(nz), (psf, psf))
    psfs = np.stack([one * (1 + 0.1 * f) for f in range(nfields)])
    wmaps = (None if nfields == 1 else torch.from_numpy(rng.uniform(
        0.2, 1.0, size=(nfields, ny, nx)).astype(np.float32)).to(dev))
    fshape2 = fft2_shape((ny, nx), (psf, psf))
    kern_hats, _ = glr.precompute_spatial(
        torch.from_numpy(psfs.astype(np.float32)).to(dev), wmaps, ny, nx,
        fshape2)
    factors = {k: torch.from_numpy(v).to(dev) for k, v in
               glr.dft_spatial_factors(ny, nx, fshape2, (psf, psf)).items()}
    return (torch.from_numpy(cube).to(dev), kern_hats.real.contiguous(),
            kern_hats.imag.contiguous(), wmaps, factors)


SPATIAL_CASES = [
    dict(shape=(37, 20, 28), psf=7, nfields=1),
    dict(shape=(19, 16, 24), psf=5, nfields=2),
    dict(shape=(40, 100, 200), psf=25, nfields=1),
    dict(shape=(6, 300, 300), psf=25, nfields=1),
    dict(shape=(5, 440, 60), psf=25, nfields=1),  # kx tiles of 16
    # ny, nx, fy (45) and fxr (28) all off every multiple of 16 and 64
    dict(shape=(11, 37, 45), psf=7, nfields=2),
    # fy 864, ny + fy odd: kx tiles of 8 in bf16x3
    dict(shape=(3, 827, 20), psf=25, nfields=1),
    # fy 3456, ny + fy odd: kx tiles of 2 in bf16x3, so the two float
    # buffers end 16 bytes off a 32-byte boundary and the WMMA stage
    # after them must be realigned
    dict(shape=(2, 3413, 16), psf=25, nfields=1),
]


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
@pytest.mark.parametrize("case", SPATIAL_CASES)
def test_cuda_spatial_matches_plain(cuda, precision, case):
    args = _spatial_problem(*case["shape"], case["psf"], case["nfields"],
                            cuda)
    before = spatial_fsf.launches
    out = spatial_fsf(*args, precision=precision)
    torch.cuda.synchronize()
    assert spatial_fsf.launches == before + case["nfields"]
    ref = glr.glr_spatial_matmul(*args, precision=precision)
    ny, fy = case["shape"][1], args[1].shape[2]
    x3 = int(precision == "bf16x3")
    lib = spatial._library()
    tk = spatial._tile_columns(lib, ny, fy, x3)
    print(f"kx tile {tk}, {lib.spatial_fsf_smem_bytes(ny, fy, tk, x3)} "
          f"bytes per block, max abs err {float((out - ref).abs().max()):.3g}")
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)


def _rms(t):
    return float(t.double().square().mean().sqrt())


@pytest.mark.gpu
@pytest.mark.parametrize("case", SPATIAL_CASES)
def test_cuda_spatial_bf16x3_splits(cuda, case):
    args = _spatial_problem(*case["shape"], case["psf"], case["nfields"],
                            cuda)
    got = spatial_fsf(*args, precision="bf16x3")
    plain = glr.glr_spatial_matmul(*args, precision="bf16x3")
    highest = spatial_fsf(*args, precision="highest")
    noise = _rms(highest - glr.glr_spatial_matmul(*args))
    sep = _rms(got - highest)
    print(f"RMS: noise {noise:.3g}, from plain {_rms(got - plain):.3g}, "
          f"from highest {sep:.3g}; ratios {sep / noise:.3g} and "
          f"{sep / _rms(got - plain):.3g}")
    assert sep >= 4 * noise
    assert sep >= 1.5 * _rms(got - plain)


def _sweep_values(out):
    """correl and correl_min of a sweep's outputs, stacked."""
    return torch.stack((out[0], out[2]))


@pytest.mark.gpu
@pytest.mark.parametrize("dico", DICOS)
def test_cuda_bf16x3_sweep_splits(cuda, dico):
    """The bf16x3 sweep kernel computes the three passes: it lies away from
    the float32 kernel, by at least 4 times that kernel's order noise (on
    an H100 the float32 kernel and its cuBLAS plain version agree bit for
    bit here, so the noise is 0), and at least 1.5 times nearer its own
    plain version."""
    nz = 700
    (x, n, t_num, t_den), pad_left = _problem(dico, nz, 20, 30, cuda)
    args = (x, n, t_num, t_den, pad_left, nz)
    got = _sweep_values(spectral_sweep(*args, precision="bf16x3"))
    plain = _sweep_values(glr.toeplitz_sweep(*args, precision="bf16x3"))
    highest = _sweep_values(spectral_sweep(*args))
    noise = _rms(highest - _sweep_values(glr.toeplitz_sweep(*args)))
    sep, err = _rms(got - highest), _rms(got - plain)
    print(f"RMS: noise {noise:.3g}, from plain {err:.3g}, from highest "
          f"{sep:.3g}")
    assert sep > 0 and sep >= 4 * noise
    assert sep >= 1.5 * err


def _same_bits(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("entry", ["banded", "matched_filter"])
@pytest.mark.parametrize("dico", DICOS)
@pytest.mark.parametrize("shape", SWEEP_SHAPES)
def test_cuda_spaxel_major_sweeps_match_plain(cuda, shape, dico, entry):
    """With a NaN sample and a den < 0 spaxel: the kernels sum each
    profile's span only, the banded plain version its whole (W, block)
    window, so ``_hold``'s footprint rule pins where they differ.  Both
    entries run the float32 sweep's arithmetic on the same taps, so their
    outputs equal ``spectral_sweep``'s on the cube layout bit for bit."""
    nz = shape[0]
    (x, n, t_num, t_den), pad_left = _problem(dico, *shape, cuda, nan=True)
    xs = x.reshape(nz, -1).T.contiguous()
    ns = n.reshape(nz, -1).T.contiguous()
    if entry == "banded":
        fn = kernels.banded_matmul_spectral
        before = fn.launches
        c, m, p = fn(xs, ns, t_num, t_den, pad_left, nz)
        cr, mr, pr = kernels.banded_matmul_plain(xs, ns, t_num, t_den,
                                                 pad_left, nz)
    else:
        bank, bank2, centers = glr._pack_profiles(
            _profiles(dico, np.random.default_rng(6)))
        fn = kernels.matched_filter_spectral
        before = fn.launches
        c, m, p = fn(xs, ns, bank, bank2, centers)
        cr, mr, pr = kernels.matched_filter_plain(
            xs, ns, torch.from_numpy(bank), torch.from_numpy(bank2), centers)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    back = lambda a: a.T.reshape(x.shape)
    _hold((back(c), back(p), back(m)), (back(cr), back(pr), back(mr)), x, n,
          t_num, t_den, pad_left, index_dtype=torch.int32)
    ck, pk, mk = spectral_sweep(x, n, t_num, t_den, pad_left, nz)
    assert _same_bits(back(c), ck) and _same_bits(back(m), mk)
    assert torch.equal(back(p), pk.to(torch.int32))


@pytest.mark.gpu
def test_cuda_wrapper_checks_its_inputs(cuda):
    (x, n, t_num, t_den), pad_left = _problem(DICO_3FWHM, 64, 4, 4, cuda)
    with pytest.raises(TypeError):
        spectral_sweep(x.double(), n, t_num, t_den, pad_left, 64)
    with pytest.raises(ValueError):
        spectral_sweep(x, n.cpu(), t_num, t_den, pad_left, 64)
    with pytest.raises(ValueError):
        spectral_sweep(x.transpose(1, 2), n.transpose(1, 2), t_num, t_den,
                       pad_left, 64)


# -- step 08: line estimation (stock torch ops) on the card against the CPU --
# The same functions on both devices; float32 sums in another order, so the
# values are held at rtol 1e-4 (per-channel arrays with an atol of 1e-4
# times their largest magnitude) and positions and ok exactly.
@pytest.mark.gpu
@pytest.mark.parametrize("sg", [5, 25])
def test_cuda_gather_windows_matches_cpu(cuda, sg):
    raw, var, _, _ = lines_cases.field()
    ys, xs = torch.tensor([0, 10, 20, 3]), torch.tensor([0, 10, 20, 17])
    for arr, fill in ((raw, 0.0), (var, float("inf"))):
        arr = torch.from_numpy(arr)
        want = lines.gather_windows(arr, ys, xs, sg, fill)
        got = lines.gather_windows(arr.to(cuda), ys.to(cuda), xs.to(cuda),
                                   sg, fill)
        assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
def test_cuda_method_pca_wgt_matches_cpu(cuda):
    from origin_tpu_torch.ops.dct import dctmat

    cubes = [lines_cases.line_minicube(seed=s, z0=z) for s, z in
             ((43, 30), (7, 12), (8, 47))]
    args = [torch.from_numpy(np.stack([c[i] for c in cubes]))
            for i in (0, 1)]
    args += [torch.from_numpy(cubes[0][2]), torch.from_numpy(dctmat(60, 30))]
    want = lines.method_pca_wgt(*args)
    got = lines.method_pca_wgt(*(a.to(cuda) for a in args))
    for g, w in zip(got, want):
        w = w.numpy()
        np.testing.assert_allclose(g.cpu().numpy(), w, rtol=1e-4,
                                   atol=1e-4 * np.abs(w).max())


@pytest.mark.gpu
@pytest.mark.parametrize("criteria", ["flux", "mse"])
@pytest.mark.parametrize("mosaic", [False, True], ids=["field", "mosaic"])
@pytest.mark.parametrize("g", [0, 1])
@pytest.mark.parametrize("which", ["field", "small_field"])
def test_cuda_grid_analysis_matches_cpu(cuda, which, g, mosaic, criteria):
    fld = getattr(lines_cases, which)()
    _, ny, nx = fld[0].shape
    kw = dict(size_grid=g, criteria=criteria)
    want = lines.grid_analysis_batch(
        *lines_cases.grid_inputs(fld, mosaic, g, "cpu"), ny, nx, **kw)
    got = lines.grid_analysis_batch(
        *lines_cases.grid_inputs(fld, mosaic, g, cuda), ny, nx, **kw)
    lines_cases.hold({k: v.cpu().numpy() for k, v in got.items()},
                     {k: v.numpy() for k, v in want.items()}, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("mosaic", [False, True], ids=["field", "mosaic"])
def test_cuda_estimation_line_arrays_matches_cpu(cuda, mosaic):
    *args, kw = lines_cases.chunk_case(mosaic)
    lines_cases.hold(lines.estimation_line_arrays(*args, device=cuda, **kw),
                     lines.estimation_line_arrays(*args, device="cpu", **kw),
                     rtol=1e-4)


# -- steps 10-11: the window ops (stock torch ops) on the card against the CPU
# The same functions on both devices (inputs: tests/sources_cases.py): the
# max images and max maps exactly (a max is exact), the window cutouts
# exactly, the sums in another order: the object-mean spectra at rtol 1e-6
# and the source spectra within 1e-5 of each row's largest magnitude, with
# NaN and infinities in the same places.
@pytest.mark.gpu
@pytest.mark.parametrize("size", sources_cases.SIZES)
def test_cuda_line_max_images_matches_cpu(cuda, size):
    cube = torch.from_numpy(sources_cases.detection_cube())
    jobs = sources_cases.line_jobs(size)
    want, wvalid = cutouts.line_max_images(cube, *jobs, size)
    got, valid = cutouts.line_max_images(cube.to(cuda), *jobs, size)
    assert torch.equal(valid.cpu(), wvalid)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.gpu
@pytest.mark.parametrize("size", sources_cases.SIZES)
def test_cuda_window_ori_stats_matches_cpu(cuda, size):
    cube = torch.from_numpy(sources_cases.detection_cube())
    y0, x0 = sources_cases.window_starts(size)
    objm = sources_cases.object_masks(size, len(y0))
    want = cutouts.window_ori_stats(cube, y0, x0, objm, size)
    got = cutouts.window_ori_stats(cube.to(cuda), y0, x0, objm, size)
    np.testing.assert_array_equal(got[1].cpu().numpy(), want[1].numpy())
    spec, wspec = got[0].cpu().numpy(), want[0].numpy()
    sources_cases.same_nonfinite(spec, wspec)
    fin = np.isfinite(wspec)
    np.testing.assert_allclose(spec[fin], wspec[fin], rtol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("has_psf", [True, False], ids=["psf", "no_psf"])
@pytest.mark.parametrize("size", sources_cases.SIZES)
def test_cuda_source_spectra_matches_cpu(cuda, size, has_psf):
    case = sources_cases.spectra_inputs(size)
    names = ("cube", "var", "mask", "y0", "x0", "objm", "skym", "wcube",
             "lsrc", "lw")
    args = [torch.from_numpy(np.ascontiguousarray(case[k])) for k in names]
    want = spectra.source_spectra(*args, size, has_psf)
    got = spectra.source_spectra(*(a.to(cuda) for a in args), size, has_psf)
    assert sorted(got) == sorted(want)
    for key in want:
        sources_cases.hold_rows(got[key].cpu().numpy(), want[key].numpy(),
                                1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("size", [4, 5, 7])
def test_cuda_tensor_cube_subcube_matches_cpu(cuda, size):
    from origin_tpu_torch.core.coords import WCS, WaveCoord
    from origin_tpu_torch.pipeline.products import TensorCube

    cube = torch.from_numpy(sources_cases.detection_cube())
    wcs = WCS(crpix=(3.0, 4.0), crval=(-30.0, 53.0))
    wave = WaveCoord(crpix=1.0, crval=4750.0, cdelt=1.25)
    host, card = (TensorCube(c, wcs=wcs, wave=wave)
                  for c in (cube, cube.to(cuda)))
    for center in [(5.0, 7.0), (2.5, 3.5), (-1.0, 7.0), (11.5, -2.0),
                   (13.0, 16.0), (30.0, 40.0)]:
        a, b = card.subcube(center, size), host.subcube(center, size)
        for name in ("data", "mask"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        assert tuple(a.wcs.crpix) == tuple(b.wcs.crpix)


STORE_KNOBS = ("ORIGIN_TPU_STORE_RECIPES", "ORIGIN_TPU_STORE_SPARSE",
               "ORIGIN_TPU_STORE_INT16", "ORIGIN_TPU_CORREL_WIRE")


def _minicube_resume(tmp_path):
    """(the minicube's steps 01-07 on the card, the session written after
    its step 04, loaded on the card, with steps 05-07 run from it, the
    sweep's launches in those steps)."""
    from origin_tpu_torch.pipeline.session import ORIGIN
    from tools_torch.synthetic import make_minicube, make_segmap

    cube_fn, seg_fn = str(tmp_path / "mini.fits"), str(tmp_path / "seg.fits")
    make_minicube(cube_fn)
    make_segmap(seg_fn)

    def steps(orig, which):
        calls = dict(
            step01=lambda: orig.step01_preprocessing(),
            step02=lambda: orig.step02_areas(minsize=30, maxsize=60),
            step03=lambda: orig.step03_compute_PCA_threshold(),
            step04=lambda: orig.step04_compute_greedy_PCA(),
            step05=lambda: orig.step05_compute_TGLR(),
            step06=lambda: orig.step06_compute_purity_threshold(purity=0.8),
            step07=lambda: orig.step07_detection(segmap=seg_fn))
        for name in which:
            calls[name]()
        return orig

    kw = dict(path=str(tmp_path), loglevel="WARNING", device="cuda")
    front, back = ("step01", "step02", "step03", "step04"), (
        "step05", "step06", "step07")
    full = steps(ORIGIN.init(cube_fn, name="full", **kw), front + back)
    steps(ORIGIN.init(cube_fn, name="b", **kw), front).write()
    resumed = ORIGIN.load(str(tmp_path / "b"), device="cuda")
    spectral_sweep.launches = 0
    steps(resumed, back)
    launches = spectral_sweep.launches
    for o in (full, resumed):
        o.close_logfile()
    return full, resumed, launches


@pytest.mark.gpu
def test_cuda_session_resumes_after_step04(cuda, tmp_path, monkeypatch):
    """The minicube written after step 04 on the card in dense files and
    loaded there: step 05 launches the sweep kernel on the cube_faint read
    back from the session file, and Cat0/Cat1 and the thresholds equal
    those of a run that never stopped."""
    from origin_tpu_torch.pipeline.products import TensorCube

    for knob in STORE_KNOBS[:3]:
        monkeypatch.setenv(knob, "0")
    full, resumed, launches = _minicube_resume(tmp_path)
    assert launches > 0
    faint = resumed.steps["compute_greedy_PCA"].store.peek("cube_faint")
    assert isinstance(faint, TensorCube) and faint.tensor.is_cuda
    for key in ("threshold", "threshold_std"):
        assert resumed.param[key] == full.param[key]
    for name in ("Cat0", "Cat1"):
        a, b = getattr(resumed, name), getattr(full, name)
        assert a.colnames == b.colnames and len(a) == len(b) > 0
        for col in a.colnames:
            np.testing.assert_array_equal(np.asarray(a[col]),
                                          np.asarray(b[col]), err_msg=col)


@pytest.mark.gpu
def test_cuda_compact_session_resumes_after_step04(cuda, tmp_path,
                                                   monkeypatch):
    """The same in the default compact files: cube_faint comes back from
    its recipe, rebuilt on the host, so the sweep kernel still launches on
    it and Cat0/Cat1 keep the counts of the CPU test
    (tests/test_torch_compact_session.py), the thresholds within 1e-3."""
    from origin_tpu_torch import fitsio

    for knob in STORE_KNOBS:
        monkeypatch.delenv(knob, raising=False)
    full, resumed, launches = _minicube_resume(tmp_path)
    assert launches > 0
    hdr = fitsio.getheader(str(tmp_path / "b" / "cube_faint.fits"))
    assert hdr["ORITPURE"] == "pca_faint"
    assert resumed.cube_faint.tensor.is_cuda
    for key in ("threshold", "threshold_std"):
        assert abs(resumed.param[key] - full.param[key]) <= 1e-3
    assert (len(resumed.Cat0), len(resumed.Cat1)) == (
        len(full.Cat0), len(full.Cat1)) == (15, 14)


def _tight_front(tmp_path, monkeypatch, precision, budget, sweeps=None):
    """The minicube's steps 01-05 on the card at ``precision`` under the
    memory budget ``budget`` (None: the card's); returns the session, the
    launches of steps 01-05 and, per ``maybe_offload`` call, the device
    memory allocated before and after it.  With the list ``sweeps``, each
    sweep of step 05 appends its arguments and a copy of its outputs."""
    from origin_tpu_torch.pipeline import engine as tengine
    from origin_tpu_torch.pipeline.engine import TorchEngine
    from origin_tpu_torch.pipeline.session import ORIGIN
    from tools_torch.synthetic import make_minicube

    cube_fn = str(tmp_path / "mini.fits")
    make_minicube(cube_fn)
    monkeypatch.setenv("ORIGIN_TPU_PRECISION", precision)
    if budget is None:
        monkeypatch.delenv("ORIGIN_TPU_HBM_BYTES", raising=False)
    else:
        monkeypatch.setenv("ORIGIN_TPU_HBM_BYTES", budget)
    freed = []
    real = TorchEngine.maybe_offload

    def spy(self, *names):
        # earlier sessions' garbage must not be collected in between
        gc.collect()
        gc.disable()
        try:
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            real(self, *names)
            freed.append((names, before, torch.cuda.memory_allocated()))
        finally:
            gc.enable()

    for owner, attr in ((spectral_sweep, "launches"),
                        (spectral_sweep, "launches_bf16x3"),
                        (spatial_fsf, "launches")):
        setattr(owner, attr, 0)
    orig = ORIGIN.init(cube_fn, name=f"s{budget}", path=str(tmp_path),
                       loglevel="WARNING", device="cuda")
    def recorder(*args, **kw):
        out = spectral_sweep(*args, **kw)
        sweeps.append((args, kw, tuple(o.clone() for o in out)))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TorchEngine, "maybe_offload", spy)
        if sweeps is not None:
            mp.setattr(tengine, "spectral_sweep", recorder)
        orig.step01_preprocessing()
        orig.step02_areas(minsize=30, maxsize=60)
        orig.step03_compute_PCA_threshold()
        orig.step04_compute_greedy_PCA()
        orig.step05_compute_TGLR()
    launches = dict(highest=spectral_sweep.launches,
                    bf16x3=spectral_sweep.launches_bf16x3,
                    spatial=spatial_fsf.launches)
    orig.close_logfile()
    return orig, launches, freed


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
def test_cuda_tight_step05_matches_normal(cuda, tmp_path, monkeypatch,
                                          precision):
    """The tight step 05 (spatial stage in spectral slabs, FFTs) launches
    the session precision's sweep kernel once and never the spatial
    kernel; the kernel's outputs hold its plain version's on the same
    chunked spatial output (the module's sweep tolerances), and the
    statistic holds the normal mode's at the cross-package atol 1e-3 of
    tests/test_torch_pipeline.py (the two spatial stages sum in other
    orders, and in bf16x3 the normal one splits its products)."""
    normal, n_launch, n_freed = _tight_front(tmp_path, monkeypatch,
                                             precision, None)
    sweeps = []
    tight, t_launch, _ = _tight_front(tmp_path, monkeypatch, precision,
                                      "1e6", sweeps)
    assert not normal.engine.tight_memory and tight.engine.tight_memory
    assert not any(after < before for _, before, after in n_freed)
    other = "bf16x3" if precision == "highest" else "highest"
    assert t_launch == {precision: 1, other: 0, "spatial": 0}
    [(args, kw, (c, p, m))] = sweeps
    assert kw["precision"] == precision
    cr, pr, mr = glr.toeplitz_sweep(*args, **kw)
    torch.testing.assert_close(c, cr, atol=1e-5, rtol=1e-5, equal_nan=True)
    torch.testing.assert_close(m, mr, atol=1e-5, rtol=1e-5, equal_nan=True)
    _assert_ties(p, pr, *args[:5], precision)
    assert n_launch[precision] == 1
    for name in ("cube_correl", "cube_correl_min"):
        a = tight.engine.get(name).cpu()
        b = normal.engine.get(name).cpu()
        torch.testing.assert_close(a, b, rtol=0, atol=1e-3)
    same = (tight.cube_profile.tensor == normal.cube_profile.tensor)
    assert same.float().mean().item() >= 0.999
    for name in ("maxmap", "minmap"):
        np.testing.assert_allclose(getattr(tight, name).data,
                                   getattr(normal, name).data, rtol=0,
                                   atol=1e-3)


@pytest.mark.gpu
def test_cuda_tight_offloads_free_device_memory(cuda, tmp_path, monkeypatch):
    """Each eager offload of a tight session (after steps 01, 04 and 05)
    lowers the allocated device memory, and the products hold none."""
    orig, _, freed = _tight_front(tmp_path, monkeypatch, "highest", "1e6")
    assert [names for names, _, _ in freed] == [
        ("cont_dct",), ("cube_std",), ("cube_faint", "cube_correl_min")]
    for names, before, after in freed:
        assert after < before, names
    for name in ("cont_dct", "cube_std", "cube_faint", "cube_correl_min"):
        assert not orig.engine.on_device(name), name
    assert not orig.engine.inputs_resident()
    assert orig.engine.on_device("cube_correl")


# the encoders' cases (tests/test_torch_store.py has them against the JAX
# package on the CPU): sub-half-step extrema, an all-zero cube, odd shapes
# and one past the dense encoder's slab of 256 channels
def _quant_case(name):
    rng = np.random.default_rng(12)
    if name == "all_zero":
        return np.zeros((9, 4, 5), np.float32)
    shape = dict(sub_half_step=(40, 6, 7), odd_7x3x5=(7, 3, 5),
                 odd_1x1x1=(1, 1, 1), odd_1x9x1=(1, 9, 1),
                 slabs_700x20x30=(700, 20, 30))[name]
    x = np.where(rng.random(shape) < 0.2, rng.standard_normal(shape) * 8, 0)
    if name == "sub_half_step":
        x.ravel()[[3, 50, 51, 400]] = [1e-7, -3e-6, 2e-4, -1e-30]
    return x.astype(np.float32)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ("sub_half_step", "all_zero", "odd_7x3x5",
                                  "odd_1x1x1", "odd_1x9x1",
                                  "slabs_700x20x30"))
def test_cuda_encoders_match_cpu(cuda, name):
    """encode_i16 and sparse_i16 on the card give the CPU's bits: division
    and rounding are correctly rounded on both."""
    from origin_tpu_torch.ops.quant import encode_i16, sparse_i16

    x = torch.from_numpy(_quant_case(name))
    q, scale = encode_i16(x)
    qc, scale_c = encode_i16(x.to(cuda))
    assert scale_c == scale
    np.testing.assert_array_equal(qc.cpu().numpy(), q.numpy())
    q2, _ = encode_i16(x.to(cuda), scale=scale)
    np.testing.assert_array_equal(q2.cpu().numpy(), q.numpy())
    idx, vals, scale = sparse_i16(x)
    idxc, valsc, scale_c = sparse_i16(x.to(cuda))
    assert scale_c == scale and idxc.dtype == idx.dtype == torch.int32
    np.testing.assert_array_equal(idxc.cpu().numpy(), idx.numpy())
    np.testing.assert_array_equal(valsc.cpu().numpy(), vals.numpy())


def _assert_same_catalogs(a, b, names):
    for name in names:
        x, y = getattr(a, name), getattr(b, name)
        assert x.colnames == y.colnames and len(x) == len(y) > 0, name
        for col in y.colnames:
            np.testing.assert_array_equal(np.asarray(x[col]),
                                          np.asarray(y[col]),
                                          err_msg=f"{name} {col}")


@pytest.mark.gpu
def test_cuda_cli_run_and_status(cuda, tmp_path, capsys):
    """``python -m origin_tpu_torch run`` on the card (the default
    --device): the sweep kernel launches and the minicube's goldens come
    back (Cat0 / Cat1 15 / 14, Cat3 14 lines / 13 sources); ``status``
    lists the 11 steps as DUMPED."""
    from origin_tpu_torch.__main__ import main
    from origin_tpu_torch.core import Table
    from tools_torch.synthetic import make_minicube, make_segmap

    cube_fn, seg_fn = str(tmp_path / "mini.fits"), str(tmp_path / "seg.fits")
    make_minicube(cube_fn)
    make_segmap(seg_fn)
    spectral_sweep.launches = 0
    assert main(["run", cube_fn, "--name", "cli", "--path", str(tmp_path),
                 "--purity", "0.8", "--minsize", "30", "--segmap", seg_fn,
                 "--loglevel", "WARNING"]) == 0
    assert spectral_sweep.launches > 0
    folder = tmp_path / "cli"
    counts = [len(Table.read(str(folder / f"{n}.fits")))
              for n in ("Cat0", "Cat1", "Cat3_lines", "Cat3_sources")]
    assert counts == [15, 14, 14, 13]
    assert len(list((folder / "sources").iterdir())) == 13
    capsys.readouterr()
    assert main(["status", str(folder)]) == 0
    out = capsys.readouterr().out
    assert out.count(": DUMPED") == 11


@pytest.mark.gpu
def test_cuda_reference_export_resumes(cuda, tmp_path):
    """A session on the card after step 04, exported in the reference
    dialect and loaded on the card: step 05 launches the sweep kernel on
    the exported cube_faint, and Cat0-Cat3 equal those of a run that
    never stopped."""
    from origin_tpu_torch.pipeline.session import ORIGIN
    from origin_tpu_torch.pipeline.steps import Status
    from tools_torch.synthetic import make_minicube, make_segmap

    cube_fn, seg_fn = str(tmp_path / "mini.fits"), str(tmp_path / "seg.fits")
    make_minicube(cube_fn)
    make_segmap(seg_fn)

    def steps(orig, which):
        calls = (lambda: orig.step01_preprocessing(),
                 lambda: orig.step02_areas(minsize=30, maxsize=60),
                 lambda: orig.step03_compute_PCA_threshold(),
                 lambda: orig.step04_compute_greedy_PCA(),
                 lambda: orig.step05_compute_TGLR(),
                 lambda: orig.step06_compute_purity_threshold(purity=0.8),
                 lambda: orig.step07_detection(segmap=seg_fn),
                 lambda: orig.step08_compute_spectra(),
                 lambda: orig.step09_clean_results())
        for i in which:
            calls[i - 1]()
        return orig

    kw = dict(path=str(tmp_path), loglevel="WARNING", device="cuda")
    full = steps(ORIGIN.init(cube_fn, name="full", **kw), range(1, 10))
    b = steps(ORIGIN.init(cube_fn, name="b", **kw), range(1, 5))
    (tmp_path / "ref").mkdir()
    folder = b.write(path=str(tmp_path / "ref"), compat="reference")
    b.close_logfile()
    resumed = ORIGIN.load(folder, device="cuda")
    assert [s.status for s in resumed.steps.values()][:5] == (
        [Status.DUMPED] * 4 + [Status.NOTRUN])
    spectral_sweep.launches = 0
    steps(resumed, range(5, 10))
    assert spectral_sweep.launches > 0
    assert resumed.cube_faint.tensor.is_cuda
    for key in ("threshold", "threshold_std"):
        assert resumed.param[key] == full.param[key]
    _assert_same_catalogs(resumed, full, ("Cat0", "Cat1", "Cat2",
                                          "Cat3_lines", "Cat3_sources"))
    for o in (full, resumed):
        o.close_logfile()


@pytest.mark.gpu
@pytest.mark.parametrize("precision", ["highest", "bf16x3"])
@pytest.mark.parametrize("dico", [DICO_3FWHM, DICO_FWHM_2_12])
def test_cuda_mesh_tile_sweep_matches_plain(cuda, dico, precision):
    """A mesh session's sweep input: one (3681, 25, 200) row tile of the
    3681 x 100 x 200 field at sp=4, with den <= 0 spaxels and a NaN
    sample, held to the plain sweep by ``_hold`` (each kernel's NaN
    footprint exactly); one launch."""
    nz = 3681
    (x, n, t_num, t_den), pad_left = _problem(dico, nz, 25, 200, cuda,
                                              nan=True)
    attr = "launches_bf16x3" if precision == "bf16x3" else "launches"
    before = getattr(spectral_sweep, attr)
    got = spectral_sweep(x, n, t_num, t_den, pad_left, nz,
                         precision=precision)
    torch.cuda.synchronize()
    assert getattr(spectral_sweep, attr) == before + 1
    ref = glr.toeplitz_sweep(x, n, t_num, t_den, pad_left, nz,
                             precision=precision)
    _hold(got, ref, x, n, t_num, t_den, pad_left, precision)


@pytest.mark.gpu
def test_cuda_mesh_session_matches_single_device(cuda, tmp_path):
    """The minicube on a 4-slot mesh of one card (``["cuda:0"] * 4``)
    against the single-device session, by tests/test_parallel.py's rules:
    mapO2 agreeing above 0.99, the thresholds within 0.05 / 0.02, and at
    the single device's thresholds the same Cat0 and Cat1; step 05
    launches the sweep kernel once per tile."""
    from origin_tpu_torch.parallel import make_mesh
    from origin_tpu_torch.parallel.mesh import RowShards
    from origin_tpu_torch.pipeline.session import ORIGIN
    from tools_torch.synthetic import make_minicube, make_segmap

    cube_fn, seg_fn = str(tmp_path / "mini.fits"), str(tmp_path / "seg.fits")
    make_minicube(cube_fn)
    make_segmap(seg_fn)
    launches = {}

    def run(name, mesh):
        orig = ORIGIN.init(cube_fn, name=name, path=str(tmp_path),
                           loglevel="WARNING", device="cuda", mesh=mesh)
        orig.step01_preprocessing()
        orig.step02_areas(minsize=30, maxsize=60)
        orig.step03_compute_PCA_threshold()
        orig.step04_compute_greedy_PCA()
        before = spectral_sweep.launches
        orig.step05_compute_TGLR()
        launches[name] = spectral_sweep.launches - before
        orig.step06_compute_purity_threshold(purity=0.8)
        return orig

    ref = run("single", None)
    shd = run("mesh", make_mesh(4, dp=1, devices=["cuda:0"] * 4))
    assert launches == {"single": 1, "mesh": 4}
    tiles = shd.steps["compute_TGLR"].store.peek("cube_correl").tensor
    assert isinstance(tiles, RowShards) and all(
        s.is_cuda for s in tiles.shards)
    assert np.mean(shd.mapO2.data == ref.mapO2.data) > 0.99
    assert abs(shd.param["threshold"] - ref.param["threshold"]) <= 0.05
    assert abs(shd.param["threshold_std"]
               - ref.param["threshold_std"]) <= 0.02
    thr, thr_std = ref.param["threshold"], ref.param["threshold_std"]
    for o in (ref, shd):
        o.step07_detection(threshold=thr, threshold_std=thr_std,
                           segmap=seg_fn)
    for name in ("Cat0", "Cat1"):
        keyed = [sorted(zip(*(np.asarray(getattr(o, name)[k]).tolist()
                              for k in ("x0", "y0", "z0", "comp"))))
                 for o in (ref, shd)]
        assert keyed[0] == keyed[1] and len(keyed[0]) > 0, name
    for o in (ref, shd):
        o.close_logfile()


# -- the streamed ingest (pipeline/ingest.py, TorchEngine.stream_inputs) ----
def _ingest_inputs(orig):
    eng = orig.engine
    return tuple(t.cpu() for t in (eng.input_cube(), eng.input_var(),
                                   eng.input_mask()))


@pytest.mark.gpu
def test_cuda_streamed_inputs_equal_the_cpu_route(cuda, tmp_path,
                                                  monkeypatch):
    """The minicube (NaN voxels, STAT) streamed to the card in several
    slabs, through pinned buffers on a copy stream: its inputs equal, bit
    for bit, the CPU route's, the eager read's with its copies started at
    init and the upload at step 01's."""
    from origin_tpu_torch.pipeline import engine as tengine
    from origin_tpu_torch.pipeline import ingest
    from origin_tpu_torch.pipeline.session import ORIGIN
    from tools_torch.synthetic import make_minicube

    fn = str(tmp_path / "mini.fits")
    make_minicube(fn)
    monkeypatch.setattr(ingest, "_SLAB_BYTES", 10 ** 6)
    kw = dict(path=str(tmp_path), loglevel="WARNING")
    streamed = ORIGIN.init(fn, name="streamed", device="cuda", **kw)
    staged = streamed.engine._staged
    assert staged is not None and staged.stream is not None
    assert staged.stream != torch.cuda.current_stream()
    assert all(t.is_cuda for t in staged.raw.values())
    ring = tengine._RINGS[True]
    assert all(b.is_pinned() for b in ring.bufs)
    assert ring.events[0] is not None  # the ring took the copies
    cpu = ORIGIN.init(fn, name="cpu", device="cpu", **kw)
    monkeypatch.setenv("ORIGIN_TPU_STREAM_INGEST", "0")
    eager = ORIGIN.init(fn, name="eager", device="cuda", **kw)
    assert eager.engine._staged is not None
    step01 = ORIGIN.init(fn, name="step01", device="cuda", **kw)
    step01.engine.release()
    got = _ingest_inputs(streamed)
    assert bool(got[2].any())
    for other in (cpu, eager, step01):
        for a, b in zip(got, _ingest_inputs(other)):
            assert torch.equal(a, b), other.name
    for o in (streamed, cpu, eager, step01):
        o.close_logfile()


@pytest.mark.gpu
def test_cuda_release_mid_stream_leaves_no_pending_copy(cuda):
    """``release()`` of an engine whose inputs are still being copied
    waits for the copies before it drops them."""
    from types import SimpleNamespace

    from origin_tpu_torch.pipeline import engine as tengine

    orig = SimpleNamespace(shape=(64, 512, 512), steps={}, outpath=".")
    eng = tengine.TorchEngine(orig, "cuda")
    staged = tengine._StagedInputs(eng.device, orig.shape, True)
    host = np.random.default_rng(0).random(orig.shape, np.float32)
    staged.put("data", host[:48])  # 48 of 64 planes queued
    eng._staged = staged
    eng.release()
    assert eng._staged is None and staged.stream.query()
    torch.testing.assert_close(staged.raw["data"][:48].cpu(),
                               torch.from_numpy(host[:48]), rtol=0, atol=0)
