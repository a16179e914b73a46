"""Host-side data substrate: containers, coordinates, tables, FSF, profiles.

The port's copies of the modules of ``origin_tpu.core`` that it uses.
"""

from .containers import Cube, Image, Spectrum
from .coords import WCS, WaveCoord
from .fsf import FieldsMap, MoffatFSF, moffat_image, read_fsf_from_header
from .profiles import (
    DICO_3FWHM,
    DICO_FWHM_2_12,
    default_dictionary_path,
    gaussian_profile,
    load_dictionary,
    make_profiles,
    write_dictionary,
)
from .table import Table, join, vstack

__all__ = [
    "Cube", "Image", "Spectrum", "WCS", "WaveCoord",
    "FieldsMap", "MoffatFSF", "moffat_image", "read_fsf_from_header",
    "Table", "join", "vstack",
    "DICO_3FWHM", "DICO_FWHM_2_12", "default_dictionary_path",
    "gaussian_profile", "load_dictionary", "make_profiles", "write_dictionary",
]
