"""Host-side detection machinery (numpy): segmentation, areas, merging,
catalogs — copies of origin_tpu.detect with the imports switched."""

from .areas import (
    area_growing,
    area_segmentation_convex_fusion,
    area_segmentation_final,
    area_segmentation_sources_fusion,
    area_segmentation_square_fusion,
    fusion_areas,
    spatial_segmentation,
)
from .catalog import (
    add_tglr_stat,
    compute_true_purity,
    merge_similar_lines,
    purity_estimation,
    unique_sources,
)
from .merging import filter_duplicate_lines, spatiospectral_merging
from .segmentation import (
    compute_deblended_segmap,
    compute_segmap_gauss,
    deblend_sources,
    detect_sources,
    make_source_mask,
    sigma_clipped_stats,
)

__all__ = [
    "area_growing", "area_segmentation_convex_fusion",
    "area_segmentation_final", "area_segmentation_sources_fusion",
    "area_segmentation_square_fusion", "fusion_areas", "spatial_segmentation",
    "add_tglr_stat", "compute_true_purity", "merge_similar_lines",
    "purity_estimation", "unique_sources",
    "filter_duplicate_lines", "spatiospectral_merging",
    "compute_deblended_segmap", "compute_segmap_gauss", "deblend_sources",
    "detect_sources", "make_source_mask", "sigma_clipped_stats",
]
