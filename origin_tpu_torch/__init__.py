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

Its top level carries the JAX package's surface, resolved at first use:
the containers (``Cube``, ``Image``, ...), the submodules (``ops``,
``detect``, ``artifacts``, ``pipeline``, ``parallel``, ``steps``) and the
reference's names (``Correlation_GLR_test``, ``Compute_GreedyPCA``, the
step classes, ...; ``_REF_PARITY``).  A function that takes host arrays
runs on its ``device`` keyword, ``"cuda"`` by default, which raises
without a GPU; one that takes tensors runs on their device.

The package imports ``torch`` and nothing of ``jax`` or of ``origin_tpu``:
it carries its own copies of the host substrate it needs (``core``,
``fitsio``, ``native``, ``version`` and the profile dictionaries in
``data``).
"""

from .version import version as __version__  # noqa: F401

#: the containers of ``core``, re-exported at the top level as in
#: ``origin_tpu`` (resolved at first use, so the import stays cheap)
_CONTAINERS = ("Cube", "Image", "Spectrum", "Table", "WCS", "WaveCoord",
               "MoffatFSF", "FieldsMap")

#: the submodules reachable as attributes
_SUBMODULES = {"steps": "pipeline.steps", "ops": "ops", "detect": "detect",
               "artifacts": "artifacts", "pipeline": "pipeline",
               "parallel": "parallel"}

#: The reference-parity surface: every name that musevlt/origin exports at
#: its top level, with the keys of ``origin_tpu._REF_PARITY``, mapped to
#: the port's counterpart of the entry point that the JAX package maps it
#: to: (module, attribute).  The snake_case names in the submodules are
#: canonical; these lazy aliases let a user of the reference find
#: everything where they expect it.
_REF_PARITY = {
    # the numerics library
    "add_tglr_stat": ("detect", "add_tglr_stat"),
    "compute_deblended_segmap": ("detect", "compute_deblended_segmap"),
    "Compute_GreedyPCA": ("ops", "greedy_pca"),
    "compute_local_max": ("ops", "compute_local_max"),
    "compute_segmap_gauss": ("detect", "compute_segmap_gauss"),
    "compute_thresh_gaussfit": ("ops", "compute_thresh_gaussfit"),
    "Compute_threshold_purity": ("ops", "compute_threshold_purity"),
    "compute_true_purity": ("detect", "compute_true_purity"),
    "Correlation_GLR_test": ("ops", "correlation_glr_test"),
    "create_masks": ("artifacts", "create_masks"),
    "estimation_line": ("ops", "estimation_line_arrays"),
    "merge_similar_lines": ("detect", "merge_similar_lines"),
    "purity_estimation": ("detect", "purity_estimation"),
    "spatial_segmentation": ("detect", "spatial_segmentation"),
    "spatiospectral_merging": ("detect", "spatiospectral_merging"),
    "unique_sources": ("detect", "unique_sources"),
    # the step framework
    "Status": ("pipeline.steps", "Status"),
    "Step": ("pipeline.steps", "Step"),
    "Preprocessing": ("pipeline.steps", "Preprocessing"),
    "CreateAreas": ("pipeline.steps", "CreateAreas"),
    "ComputePCAThreshold": ("pipeline.steps", "ComputePCAThreshold"),
    "ComputeGreedyPCA": ("pipeline.steps", "ComputeGreedyPCA"),
    "ComputeTGLR": ("pipeline.steps", "ComputeTGLR"),
    "ComputePurityThreshold": ("pipeline.steps", "ComputePurityThreshold"),
    "Detection": ("pipeline.steps", "Detection"),
    "ComputeSpectra": ("pipeline.steps", "ComputeSpectra"),
    "CleanResults": ("pipeline.steps", "CleanResults"),
    "CreateMasks": ("pipeline.steps", "CreateMasks"),
    "SaveSources": ("pipeline.steps", "SaveSources"),
    "STEPS": ("pipeline.steps", "STEPS"),
    # the source artifacts
    "gen_source_mask": ("artifacts", "gen_source_mask"),
    "create_source": ("artifacts", "create_source"),
    "create_all_sources": ("artifacts", "create_all_sources"),
    # the catalog edits
    "merge_sources": ("artifacts.source_update", "merge_sources"),
    "split_source": ("artifacts.source_update", "split_source"),
    "update_masks": ("artifacts.source_update", "update_masks"),
    "update_sources": ("artifacts.source_update", "update_sources"),
    "update_source_table": ("artifacts.source_update", "update_source_table"),
}


def __getattr__(name):
    # lazy, as in origin_tpu: `import origin_tpu_torch` stays cheap and
    # builds no kernel
    import importlib

    if name == "ORIGIN":
        from .pipeline.session import ORIGIN

        return ORIGIN
    if name in _SUBMODULES:
        return importlib.import_module("." + _SUBMODULES[name], __name__)
    if name in _CONTAINERS:
        return getattr(importlib.import_module(".core", __name__), name)
    if name in _REF_PARITY:
        mod, attr = _REF_PARITY[name]
        return getattr(importlib.import_module("." + mod, __name__), attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | {"ORIGIN"} | set(_SUBMODULES)
                  | set(_CONTAINERS) | set(_REF_PARITY))
