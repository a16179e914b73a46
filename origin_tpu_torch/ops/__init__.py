"""Device math of the detection front end, in torch.

Each module mirrors the module of the same name in ``origin_tpu.ops``.
The hand-written CUDA kernels and their wrappers: :mod:`.sweep` (the GLR
spectral sweep), :mod:`.spatial` (the spatial FSF stage of the bf16x3
mode) and :mod:`.kernels` (the spaxel-major sweeps); :mod:`.prec` holds
the bf16x3 split and :mod:`.build` the builder.
"""
