"""Spectra collection (de)serialization.

(The port's copy of ``origin_tpu/pipeline/spectra_io.py``.)

One FITS file with a DATA<id>/STAT<id> extension pair per line spectrum,
matching the layout of reference steps.py:76-98.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from .. import fitsio
from ..core.containers import Spectrum
from ..core.coords import WaveCoord

__all__ = ["save_spectra", "load_spectra"]


def save_spectra(spectra, outname):
    hdus = [fitsio.HDU()]
    for spec_id, sp in spectra.items():
        hdr = fitsio.Header()
        if sp.wave is not None:
            sp.wave.to_header(hdr, axis=1)
        hdr["EXTNAME"] = "DATA%d" % spec_id
        data = np.asarray(sp.data, dtype=np.float64)
        if sp.mask is not None:
            data = np.where(sp.mask, np.nan, data)
        hdus.append(fitsio.HDU(data=data, header=hdr))
        if sp.var is not None:
            vhdr = hdr.copy()
            vhdr["EXTNAME"] = "STAT%d" % spec_id
            hdus.append(
                fitsio.HDU(data=np.asarray(sp.var, np.float64), header=vhdr)
            )
    fitsio.write(outname, hdus)


def load_spectra(filename):
    spectra = OrderedDict()
    hdus = fitsio.read(filename)
    data_hdus = {}
    stat_hdus = {}
    for h in hdus[1:]:
        name = h.name
        if name.startswith("DATA"):
            data_hdus[int(name[4:])] = h
        elif name.startswith("STAT"):
            stat_hdus[int(name[4:])] = h
    for spec_id, h in data_hdus.items():
        wave = WaveCoord.from_header(h.header, axis=1, shape=h.data.shape[0])
        var = stat_hdus[spec_id].data if spec_id in stat_hdus else None
        spectra[spec_id] = Spectrum(data=h.data, var=var, wave=wave, copy=False)
    return spectra
