"""origin_tpu_torch — ORIGIN's detection and line estimation in PyTorch and CUDA.

A port of :mod:`origin_tpu` (JAX on a TPU) to PyTorch on an NVIDIA H100.
It runs steps 01-11 of a session, from the cube to the Cat3 line and
source catalogs and the per-source mask and FITS files, through the same
entry point (``ORIGIN.init(cube, ..., device="cuda")`` then
``step01_preprocessing()`` .. ``step11_save_sources(version)``).  The GLR
spectral sweep of step 05 runs in a hand-written CUDA kernel
(``csrc/toeplitz_sweep.cu``), in float32 or in the bf16x3 mode
(``ORIGIN_TPU_PRECISION=bf16x3``), where the spatial FSF stage runs in a
second one (``csrc/spatial_fsf.cu``); every other device stage is stock
torch.

The package imports ``torch`` and nothing of ``jax`` or of ``origin_tpu``:
it carries its own copies of the host substrate it needs (``core``,
``fitsio``, ``native``, ``version`` and the profile dictionaries in
``data``).
"""

from .version import version as __version__  # noqa: F401


def __getattr__(name):
    # lazy, as in origin_tpu: `import origin_tpu_torch` stays cheap
    if name == "ORIGIN":
        from .pipeline.session import ORIGIN

        return ORIGIN
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | {"ORIGIN"})
