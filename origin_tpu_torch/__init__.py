"""origin_tpu_torch — the ORIGIN detection front end in PyTorch and CUDA.

A port of :mod:`origin_tpu` (JAX on a TPU) to PyTorch on an NVIDIA H100.
It runs steps 01-07 of a session, from the cube to the Cat1 line catalog,
through the same entry point (``ORIGIN.init(cube, ..., device="cuda")``
then ``step01_preprocessing()`` .. ``step07_detection()``).  The GLR
spectral sweep of step 05 runs in a hand-written CUDA kernel
(``csrc/toeplitz_sweep.cu``); every other device stage is stock torch.

The package imports ``torch`` and never ``jax``.  It reuses the jax-free
host substrate of the JAX package: ``origin_tpu.core``, ``origin_tpu.fitsio``,
``origin_tpu.native`` and ``origin_tpu.version``.
"""

from origin_tpu.version import version as __version__  # noqa: F401


def __getattr__(name):
    # lazy, as in origin_tpu: `import origin_tpu_torch` stays cheap
    if name == "ORIGIN":
        from .pipeline.session import ORIGIN

        return ORIGIN
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | {"ORIGIN"})
