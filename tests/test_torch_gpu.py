"""CUDA tests of origin_tpu_torch: they need an NVIDIA GPU and skip without
one.  The file imports nothing of JAX, so it also runs where JAX is not
installed, with the repository's conftest (which imports JAX) left out:

    python -m pytest -p no:cacheprovider --noconftest -m gpu tests/test_torch_gpu.py

Tolerances: the kernel and the plain sweep sum the profile taps in
different orders, so correl and correl_min agree at atol 1e-5 + rtol
1e-5, and the best-profile index may differ only where the two candidate
profiles' statistics are within 1e-5 of each other.
"""

import numpy as np
import pytest
import torch

from origin_tpu.core.profiles import (
    DICO_3FWHM, DICO_FWHM_2_12, default_dictionary_path, load_dictionary,
)
from origin_tpu_torch.ops import glr
from origin_tpu_torch.ops.sweep import spectral_sweep, sweep_taps

torch.set_num_threads(2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _problem(dico, nz, ny, nx, dev, seed=6):
    profiles, _ = load_dictionary(default_dictionary_path(dico))
    t_num, t_den, pad_left, _ = glr.pack_profiles_toeplitz(
        glr.prepare_profiles(profiles), block=min(128, nz))
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(nz, ny, nx)).astype(np.float32)
    n = rng.uniform(0.5, 2.0, size=(nz, ny, nx)).astype(np.float32)
    n[:, 0, 0] = 0.0  # the den <= 0 guard
    return [torch.from_numpy(a).to(dev) for a in (x, n, t_num, t_den)], \
        pad_left


@pytest.mark.gpu
@pytest.mark.parametrize("dico", [DICO_3FWHM, DICO_FWHM_2_12])
@pytest.mark.parametrize("shape", [(700, 20, 30), (77, 3, 5)])
def test_cuda_kernel_matches_plain(cuda, dico, shape):
    nz = shape[0]
    (x, n, t_num, t_den), pad_left = _problem(dico, *shape, cuda)
    before = spectral_sweep.launches
    c, p, m = spectral_sweep(x, n, t_num, t_den, pad_left, nz)
    torch.cuda.synchronize()
    assert spectral_sweep.launches == before + 1
    cr, pr, mr = glr.toeplitz_sweep(x, n, t_num, t_den, pad_left, nz)
    torch.testing.assert_close(c, cr, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(m, mr, atol=1e-5, rtol=1e-5)
    assert p.dtype == pr.dtype == torch.uint8
    assert torch.all(c[:, 0, 0] == 0)
    bad = (p != pr).nonzero()
    if bad.numel():
        taps_num, taps_den, _, _ = sweep_taps(t_num, t_den)
        xs = torch.nn.functional.pad(x.double(), (0, 0, 0, 0, pad_left,
                                                  taps_num.shape[1]))
        ns = torch.nn.functional.pad(n.double(), (0, 0, 0, 0, pad_left,
                                                  taps_num.shape[1]))
        for z, yy, xx in bad.tolist():
            win_x = xs[z:z + taps_num.shape[1], yy, xx]
            win_n = ns[z:z + taps_num.shape[1], yy, xx]
            t = [float((win_x * taps_num[k].double()).sum()
                       / (win_n * taps_den[k].double()).sum().sqrt())
                 for k in (int(p[z, yy, xx]), int(pr[z, yy, xx]))]
            assert abs(t[0] - t[1]) <= 1e-5


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
