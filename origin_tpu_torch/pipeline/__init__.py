"""Pipeline orchestration for the torch port: steps 01-07, the engine and
the ORIGIN session (``from origin_tpu_torch.pipeline.session import
ORIGIN``)."""
