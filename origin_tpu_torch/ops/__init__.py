"""Device math of the detection front end, in torch.

Each module mirrors the module of the same name in ``origin_tpu.ops``;
:mod:`.sweep` holds the CUDA GLR sweep and :mod:`.build` its builder.
"""
