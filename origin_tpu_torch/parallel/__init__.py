"""Row-sharded detection over a (dp x sp) mesh of torch devices, with halo
exchange (torch port of :mod:`origin_tpu.parallel`)."""

from .mesh import (
    ShardedPipeline,
    build_tile_spatial_op,
    glr_tile,
    halo_exchange_rows,
    make_mesh,
    sharded_detect,
    sharded_detect_batch,
)
from .pca import greedy_pca_mesh

__all__ = [
    "ShardedPipeline",
    "build_tile_spatial_op",
    "glr_tile",
    "greedy_pca_mesh",
    "halo_exchange_rows",
    "make_mesh",
    "sharded_detect",
    "sharded_detect_batch",
]
