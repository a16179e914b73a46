"""Per-source artifacts: masks and source FITS files (steps 10-11), and
the catalog editing that refreshes them for chosen sources.

The port's copy of :mod:`origin_tpu.artifacts`.
"""

from .masks import create_masks, gen_source_mask
from .source import Source
from .source_creation import create_all_sources, create_source
from .source_update import (
    merge_sources,
    split_source,
    update_masks,
    update_source_table,
    update_sources,
)

__all__ = [
    "create_masks", "gen_source_mask", "Source",
    "create_all_sources", "create_source",
    "merge_sources", "split_source", "update_masks", "update_source_table",
    "update_sources",
]
