"""The GLR spectral sweep of the torch port.

The plain torch sweep (``origin_tpu_torch.ops.glr.toeplitz_sweep``, what
``spectral_sweep`` runs on a CPU tensor) is held against the JAX package's
Pallas kernel in interpret mode (``toeplitz_sweep_pallas(...,
interpret=True)``) and its XLA Toeplitz sweep (``glr_spectral_mxu``):
correl and correl_min at atol 1e-5 (the frameworks sum the 186-row band
in different orders), profile indices equal, with the same dtype.

The CUDA kernel has no CPU mode: its parity tests are in
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
from origin_tpu_torch.ops.sweep import spectral_sweep, sweep_taps

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
