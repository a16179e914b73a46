"""Benchmark of origin_tpu_torch (see README.md)."""
