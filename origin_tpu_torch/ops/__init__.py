"""Device math of the detection front end, in torch.

Each module mirrors the module of the same name in ``origin_tpu.ops``, and
this package exports the names that ``origin_tpu.ops`` exports, each bound
to its port.  The hand-written CUDA kernels and their wrappers:
:mod:`.sweep` (the GLR spectral sweep), :mod:`.spatial` (the spatial FSF
stage of the bf16x3 mode) and :mod:`.kernels` (the spaxel-major sweeps);
:mod:`.prec` holds the bf16x3 split, and :mod:`.build` compiles each
kernel at its first launch, never at import.
"""

from .convolve import fft2_shape, fftconvolve2d_same
from .dct import dct_residual, dctmat
from .glr import (
    correlation_glr_test,
    dft_spatial_factors,
    glr_spatial,
    glr_spatial_chunked,
    glr_spatial_matmul,
    glr_spatial_pre,
    glr_spectral,
    glr_spectral_mxu,
    pack_profiles_toeplitz,
    precompute_spatial,
    prepare_profiles,
    toeplitz_sweep,
)
from .lines import (
    estimation_line_arrays,
    grid_analysis_batch,
    ls_deconv_wgt,
    method_pca_wgt,
)
from .localmax import compute_local_max, local_maxima
from .pca import (
    compute_pca_threshold,
    greedy_pca,
    greedy_pca_by_area,
    rank1_left_vector,
)
from .purity import (
    compute_threshold_purity,
    compute_threshold_purity_pair,
    counts_above_thresholds,
)
from .stats import compute_thresh_gaussfit, o2test, sigma_clip, standardize

__all__ = [
    "fft2_shape", "fftconvolve2d_same",
    "dct_residual", "dctmat",
    "correlation_glr_test", "glr_spatial", "glr_spectral", "prepare_profiles",
    "glr_spatial_pre", "glr_spectral_mxu", "pack_profiles_toeplitz",
    "precompute_spatial", "glr_spatial_matmul", "glr_spatial_chunked",
    "dft_spatial_factors", "toeplitz_sweep",
    "estimation_line_arrays", "grid_analysis_batch", "ls_deconv_wgt",
    "method_pca_wgt",
    "compute_local_max", "local_maxima",
    "compute_pca_threshold", "greedy_pca", "greedy_pca_by_area",
    "rank1_left_vector",
    "compute_threshold_purity", "compute_threshold_purity_pair",
    "counts_above_thresholds",
    "compute_thresh_gaussfit", "o2test", "sigma_clip", "standardize",
]
