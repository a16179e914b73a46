"""Per-source artifacts: masks and source FITS files (steps 10-11).

The port's copy of :mod:`origin_tpu.artifacts`.  ``source_update`` (the
catalog editing that reads a written session back) comes with session I/O
(ROADMAP.md).
"""

from .masks import create_masks, gen_source_mask
from .source import Source
from .source_creation import create_all_sources, create_source

__all__ = [
    "create_masks", "gen_source_mask", "Source",
    "create_all_sources", "create_source",
]
