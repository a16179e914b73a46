"""The GLR spectral sweep of the torch port.

The plain torch sweep (``origin_tpu_torch.ops.glr.toeplitz_sweep``, what
``spectral_sweep`` runs on a CPU tensor) is held against the JAX package's
Pallas kernel in interpret mode (``toeplitz_sweep_pallas(...,
interpret=True)``) and its XLA Toeplitz sweep (``glr_spectral_mxu``):
correl and correl_min at atol 1e-5 (the frameworks sum the 186-row band
in different orders), profile indices equal, with the same dtype.

The bf16x3 kernel runs the sweep as a banded matmul over 16 x 16 blocks of
each profile's Toeplitz band (``toeplitz_blocks``, split by
``bf16x3_blocks``).  The blocks are held to the banks bit for bit, their
k-step ranges to the spans, and a product built here through them, per
16-channel group in the kernel's three passes, to the plain bf16x3 sweep
at atol 1e-5 (float32 sums in another order), indices equal but at
near-ties (1e-5).

The CUDA kernels have no CPU mode: their parity tests are in
tests/test_torch_gpu.py, marked ``gpu``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from origin_tpu.core.profiles import (
    DICO_3FWHM, DICO_FWHM_2_12, default_dictionary_path, load_dictionary,
)
from origin_tpu.ops.glr import glr_spectral_mxu
from origin_tpu.ops.pallas_sweep import toeplitz_sweep_pallas
from origin_tpu_torch.ops import glr as tglr
from origin_tpu_torch.ops.prec import split_bf16
from origin_tpu_torch.ops.sweep import (
    bf16x3_blocks, spectral_sweep, sweep_taps, toeplitz_blocks,
)

torch.set_num_threads(2)


def _banks(dico=DICO_3FWHM, nz=200, profiles=None):
    if profiles is None:
        profiles, _ = load_dictionary(default_dictionary_path(dico))
    prepped = tglr.prepare_profiles(profiles)
    t_num, t_den, pad_left, _ = tglr.pack_profiles_toeplitz(
        prepped, block=min(128, nz))
    return t_num, t_den, pad_left


def _inputs(nz=200, ny=4, nx=5, seed=0):
    rng = np.random.default_rng(seed)
    cf = rng.normal(size=(nz, ny, nx)).astype(np.float32)
    nf = rng.uniform(0.5, 2.0, size=(nz, ny, nx)).astype(np.float32)
    return cf, nf


def _plain(cf, nf, t_num, t_den, pad_left, nz):
    out = spectral_sweep(torch.from_numpy(cf), torch.from_numpy(nf),
                         torch.from_numpy(t_num), torch.from_numpy(t_den),
                         pad_left, nz)
    return [o.numpy() for o in out]


def _assert_sweep_equal(ours, ref, atol=1e-5):
    (c, p, m), (cr, pr, mr) = ours, [np.asarray(a) for a in ref]
    np.testing.assert_allclose(c, cr, rtol=0, atol=atol)
    np.testing.assert_allclose(m, mr, rtol=0, atol=atol)
    assert p.dtype == pr.dtype
    np.testing.assert_array_equal(p, pr)


@pytest.mark.parametrize("dico", [DICO_3FWHM, DICO_FWHM_2_12])
def test_plain_sweep_matches_jax(dico):
    nz = 200  # not a multiple of the 128-channel block
    cf, nf = _inputs(nz=nz)
    t_num, t_den, pad_left = _banks(dico, nz)
    ours = _plain(cf, nf, t_num, t_den, pad_left, nz)
    args = (jnp.asarray(cf), jnp.asarray(nf), jnp.asarray(t_num),
            jnp.asarray(t_den), pad_left, nz)
    _assert_sweep_equal(ours, glr_spectral_mxu(*args))
    _assert_sweep_equal(ours, toeplitz_sweep_pallas(*args, interpret=True))
    assert ours[1].dtype == np.uint8
    assert ours[1].max() == t_num.shape[0] - 1  # every profile can win


def test_forced_tie_first_profile_wins():
    profiles, _ = load_dictionary(default_dictionary_path(DICO_3FWHM))
    dup = [profiles[1], profiles[1], profiles[0]]
    nz = 150
    cf, nf = _inputs(nz=nz, seed=1)
    t_num, t_den, pad_left = _banks(nz=nz, profiles=dup)
    np.testing.assert_array_equal(t_num[0], t_num[1])
    c, p, m = _plain(cf, nf, t_num, t_den, pad_left, nz)
    assert not (p == 1).any()  # profile 1 only ever ties profile 0
    assert (p == 0).any()
    ref = glr_spectral_mxu(jnp.asarray(cf), jnp.asarray(nf),
                           jnp.asarray(t_num), jnp.asarray(t_den), pad_left,
                           nz)
    _assert_sweep_equal((c, p, m), ref)


def test_nonpositive_norm_guard():
    nz = 140
    cf, nf = _inputs(nz=nz, seed=2)
    nf[:, 1, :] = 0.0  # den == 0 -> norm +inf -> t == 0
    nf[:, 2, 2] = -1.0  # den < 0 -> the same guard
    t_num, t_den, pad_left = _banks(nz=nz)
    c, p, m = _plain(cf, nf, t_num, t_den, pad_left, nz)
    assert np.all(c[:, 1, :] == 0) and np.all(m[:, 1, :] == 0)
    assert np.all(c[:, 2, 2] == 0)
    assert np.isfinite(c).all() and np.isfinite(m).all()
    ref = glr_spectral_mxu(jnp.asarray(cf), jnp.asarray(nf),
                           jnp.asarray(t_num), jnp.asarray(t_den), pad_left,
                           nz)
    _assert_sweep_equal((c, p, m), ref)


def test_wide_dictionary_indices_are_int32():
    # 256 copies of one profile (exact ties: index 0 wins among them)
    # then four distinct widths at indices 256-259
    z = np.arange(41) - 20.0
    widths = [1.0] * 256 + [2.0, 3.5, 5.0, 7.0]
    profiles = [np.exp(-0.5 * (z / w) ** 2) for w in widths]
    nz = 64
    cf, nf = _inputs(nz=nz, ny=2, nx=3, seed=3)
    t_num, t_den, pad_left = _banks(nz=nz, profiles=profiles)
    c, p, m = _plain(cf, nf, t_num, t_den, pad_left, nz)
    assert p.dtype == np.int32 and p.max() > 255
    assert set(np.unique(p)) <= {0, 256, 257, 258, 259}
    ref = glr_spectral_mxu(jnp.asarray(cf), jnp.asarray(nf),
                           jnp.asarray(t_num), jnp.asarray(t_den), pad_left,
                           nz)
    _assert_sweep_equal((c, p, m), ref)


@pytest.mark.parametrize("dico", [DICO_3FWHM, DICO_FWHM_2_12])
@pytest.mark.parametrize("nz", [128, 77])
def test_taps_rebuild_banks_exactly(dico, nz):
    t_num, t_den, pad_left = _banks(dico, nz)
    taps_num, taps_den, start, length = (
        a.numpy() for a in sweep_taps(torch.from_numpy(t_num),
                                      torch.from_numpy(t_den)))
    nprof, window, block = t_num.shape
    reach = window - block + 1
    assert taps_num.shape == (nprof, reach)
    rebuilt_num = np.zeros_like(t_num)
    rebuilt_den = np.zeros_like(t_den)
    for k in range(nprof):
        s, n = int(start[k]), int(length[k])
        for i in range(block):
            rebuilt_num[k, s + i:s + i + n, i] = taps_num[k, s:s + n]
            rebuilt_den[k, s + i:s + i + n, i] = taps_den[k, s:s + n]
    np.testing.assert_array_equal(rebuilt_num, t_num)
    np.testing.assert_array_equal(rebuilt_den, t_den)
    # the spans are the trimmed profiles, placed at pad_left - center
    prepped = tglr.prepare_profiles(
        load_dictionary(default_dictionary_path(dico))[0])
    np.testing.assert_array_equal(length, [len(p) for p, _ in prepped])
    np.testing.assert_array_equal(start, [pad_left - c for _, c in prepped])


def test_cpu_tensor_takes_the_plain_version():
    nz = 130
    cf, nf = _inputs(nz=nz, seed=4)
    t_num, t_den, pad_left = _banks(nz=nz)
    before = spectral_sweep.launches
    ours = _plain(cf, nf, t_num, t_den, pad_left, nz)
    assert spectral_sweep.launches == before  # no kernel launched
    ref = tglr.toeplitz_sweep(torch.from_numpy(cf), torch.from_numpy(nf),
                              torch.from_numpy(t_num),
                              torch.from_numpy(t_den), pad_left, nz)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b.numpy())


def test_plain_sweep_slabs_agree():
    """The transient-memory bound splits the spaxels into slabs; the slab
    count must not change the result."""
    nz = 200
    cf, nf = _inputs(nz=nz, ny=5, nx=7, seed=5)
    t_num, t_den, pad_left = _banks(nz=nz)
    args = (torch.from_numpy(cf), torch.from_numpy(nf),
            torch.from_numpy(t_num), torch.from_numpy(t_den), pad_left, nz)
    one = tglr.toeplitz_sweep(*args)
    many = tglr.toeplitz_sweep(*args, max_transient_bytes=40_000)
    for a, b in zip(one, many):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# hand-made profiles of these lengths (centre (len - 1) // 2, random taps),
# as in tests/test_torch_gpu.py: spans of 1 to 21 taps, and 260 profiles
HAND_BANKS = dict(short_spans=[1, 2, 3, 5, 7, 9, 13, 17, 21],
                  k260=[1 + (5 * k) % 21 for k in range(260)])
BANKS = [DICO_3FWHM, DICO_FWHM_2_12, *HAND_BANKS]


def _any_banks(name, nz, seed=6):
    if name in HAND_BANKS:
        rng = np.random.default_rng(seed)
        prepped = [(p, (len(p) - 1) // 2) for p in
                   (rng.normal(size=m) for m in HAND_BANKS[name])]
    else:
        prepped = tglr.prepare_profiles(
            load_dictionary(default_dictionary_path(name))[0])
    t_num, t_den, pad_left, _ = tglr.pack_profiles_toeplitz(
        prepped, block=min(128, nz))
    return torch.from_numpy(t_num), torch.from_numpy(t_den), pad_left


def _rebuild(blocks, window, block):
    """(K, W, block) banks from (K, ND, 16, 16) blocks: column i, row r is
    block d = r // 16 - i // 16 at (i % 16, r % 16), 0 outside [0, ND)."""
    r = torch.arange(window)[:, None]
    i = torch.arange(block)[None, :]
    d = r // 16 - i // 16
    inside = (d >= 0) & (d < blocks.shape[1])
    return torch.where(inside, blocks[:, d.clamp(0, blocks.shape[1] - 1),
                                      i % 16, r % 16], 0.0)


@pytest.mark.parametrize("bank", BANKS)
@pytest.mark.parametrize("nz", [128, 77])
def test_toeplitz_blocks_rebuild_banks_exactly(bank, nz):
    t_num, t_den, _ = _any_banks(bank, nz)
    nprof, window, block = t_num.shape
    taps_num, taps_den, start, length = sweep_taps(t_num, t_den)
    for taps, bank_t in ((taps_num, t_num), (taps_den, t_den)):
        blocks, _, _ = toeplitz_blocks(taps, start, length)
        assert blocks.dtype == torch.float32
        assert blocks.shape == (nprof, (taps.shape[1] + 14) // 16 + 1, 16, 16)
        assert torch.equal(_rebuild(blocks, window, block), bank_t)
    # the kernel's operand: the split_bf16 halves of the same entries
    planes, _, _ = bf16x3_blocks(taps_num, taps_den, start, length)
    assert planes.dtype == torch.bfloat16 and planes.is_contiguous()
    halves = [*split_bf16(t_num), *split_bf16(t_den)]
    for q, want in enumerate(halves):
        got = _rebuild(planes[:, :, q].float(), window, block)
        assert torch.equal(got, want)


@pytest.mark.parametrize("bank", BANKS)
@pytest.mark.parametrize("nz", [128, 77])
def test_toeplitz_block_ranges_cover_the_spans(bank, nz):
    t_num, t_den, _ = _any_banks(bank, nz)
    taps_num, _, start, length = sweep_taps(t_num, t_den)
    blocks, d_first, d_last = toeplitz_blocks(taps_num, start, length)
    assert d_first.dtype == d_last.dtype == torch.int32
    d = torch.arange(blocks.shape[1])[None, :]
    ranged = (d >= d_first[:, None]) & (d <= d_last[:, None])
    # block d holds taps 16 d - 15 .. 16 d + 15: exactly the blocks that
    # meet [start, start + length) are in the range
    meets = ((16 * d + 15 >= start[:, None])
             & (16 * d - 15 <= (start + length - 1)[:, None]))
    assert torch.equal(ranged, meets)
    nonzero = (blocks != 0).flatten(2).any(2)
    assert not (nonzero & ~ranged).any()
    assert (d_last < blocks.shape[1]).all() and (d_first >= 0).all()


def _blocked_sweep(x, n, planes, d_first, d_last, pad_left):
    """The bf16x3 kernel's arithmetic in torch, on (nz, s) x and n: window
    row r holds sample r - pad_left, split into bf16 halves; group G of 16
    channels takes, for each profile, the k-steps d_first..d_last of each
    pass (taps hi x samples hi, taps lo x samples hi, taps hi x samples lo,
    each k-step a 16 x 16 float32 product of bf16 values), summed (hh +
    hl) + lh.  Returns (correl, profile, cmin, t) with t (K, nz, s)."""
    nz, s = x.shape
    nprof, nd = planes.shape[:2]
    ng = -(-nz // 16)
    rows = 16 * (ng + nd - 1)

    def split_window(a):
        w = torch.zeros((rows, s))
        m = min(nz, rows - pad_left)
        w[pad_left:pad_left + m] = a[:m]
        return [h.reshape(-1, 16, s) for h in split_bf16(w)]

    blk = planes.float()
    t_all = torch.empty((nprof, nz, s))
    for k in range(nprof):
        d0, d1 = int(d_first[k]), int(d_last[k])
        out = []
        for q, a in ((0, x), (2, n)):
            (bh, bl), ah, al = split_window(a), blk[k, :, q], blk[k, :, q + 1]
            passes = []
            for at, bt in ((ah, bh), (al, bh), (ah, bl)):
                acc = torch.zeros((ng, 16, s))
                for d in range(d0, d1 + 1):
                    acc = acc + torch.einsum("ab,gbs->gas", at[d],
                                             bt[d:d + ng])
                passes.append(acc)
            out.append(((passes[0] + passes[1]) + passes[2])
                       .reshape(ng * 16, s)[:nz])
        num, den = out
        t_all[k] = num / torch.where(den <= 0, float("inf"), den.sqrt())
    pdtype = torch.uint8 if nprof <= 255 else torch.int32
    best = torch.full((nz, s), float("-inf"))
    low = torch.full((nz, s), float("inf"))
    arg = torch.zeros((nz, s), dtype=pdtype)
    for k in range(nprof):
        t = t_all[k]
        arg = torch.where(t > best, torch.tensor(k, dtype=pdtype), arg)
        best = torch.maximum(best, t)
        low = torch.minimum(low, t)
    return best, arg, low, t_all


@pytest.mark.parametrize("bank", BANKS)
@pytest.mark.parametrize("nz", [128, 77])
def test_blocked_bf16x3_product_matches_plain(bank, nz):
    t_num, t_den, pad_left = _any_banks(bank, nz)
    cf, nf = _inputs(nz=nz, ny=3, nx=5, seed=7)
    x, n = torch.from_numpy(cf), torch.from_numpy(nf)
    taps = sweep_taps(t_num, t_den)
    planes, d_first, d_last = bf16x3_blocks(*taps)
    c, p, m, t = _blocked_sweep(x.reshape(nz, -1), n.reshape(nz, -1),
                                planes, d_first, d_last, pad_left)
    cr, pr, mr = (a.reshape(nz, -1) for a in tglr.toeplitz_sweep(
        x, n, t_num, t_den, pad_left, nz, precision="bf16x3"))
    torch.testing.assert_close(c, cr, atol=1e-5, rtol=0)
    torch.testing.assert_close(m, mr, atol=1e-5, rtol=0)
    assert p.dtype == pr.dtype
    z, s = (p != pr).nonzero(as_tuple=True)
    gap = (t[p[z, s].long(), z, s] - t[pr[z, s].long(), z, s]).abs()
    assert (gap <= 1e-5).all()
