"""Streamed cube ingest: the FITS decode overlapped with the device copies.

The port's copy of :mod:`origin_tpu.pipeline.ingest`, on the port's own
``fitsio``, ``Cube``, ``WCS`` and ``WaveCoord``.  The eager reader
(``Cube(filename)``) decodes the whole cube before anything else, and the
raw cube and variance must then cross the host-device link for step 01.
This module scans the FITS headers first (:func:`origin_tpu_torch.fitsio.
scan`, no payload read), then decodes the DATA and STAT payloads in
z-slabs and hands each float32 slab to a callback the moment it is
byteswapped: :meth:`~origin_tpu_torch.pipeline.engine.TorchEngine.
stream_inputs` copies it to the device while the next slab decodes.

Only the plain raw-cube layout streams: a 3-D float32 or float64 DATA
cube with an optional STAT cube of the same shape, no BSCALE / BZERO.
Anything else returns None from :meth:`IngestPlan.scan`, and the caller
reads the file with the eager ``Cube``.  ``ORIGIN_TPU_STREAM_INGEST=0``
turns streaming off; ``ORIGIN_TPU_INGEST_SLAB`` sets the slab size in
bytes.
"""

from __future__ import annotations

import os

import numpy as np

from .. import fitsio, tracing
from ..core.containers import Cube
from ..core.coords import WCS, WaveCoord

__all__ = ["IngestPlan"]

#: bytes per decoded slab: 28 slabs per input of a 3681 x 300 x 300
#: field, 7 of a 3681 x 100 x 200 one
_SLAB_BYTES = int(float(os.environ.get("ORIGIN_TPU_INGEST_SLAB", "48e6")))


def _streamable(filename):
    """(hdus, data_idx, stat_idx) when the layout supports slab reads."""
    if os.environ.get("ORIGIN_TPU_STREAM_INGEST", "1") in ("0", "false"):
        return None
    try:
        hdus = fitsio.scan(filename)
    except OSError:
        return None
    data_idx = stat_idx = None
    for i, (hdr, _, nbytes) in enumerate(hdus):
        if nbytes == 0 or str(hdr.get("XTENSION", "")).strip() == "BINTABLE":
            continue
        if int(hdr.get("NAXIS", 0)) != 3:
            return None  # unexpected image payloads: the eager reader decides
        if int(hdr["BITPIX"]) not in (-32, -64):
            return None
        if hdr.get("BSCALE", 1) != 1 or hdr.get("BZERO", 0) != 0:
            return None
        name = str(hdr.get("EXTNAME", "")).strip()
        if name == "STAT":
            stat_idx = i
        elif data_idx is None or name == "DATA":
            data_idx = i
        else:
            return None  # two data-like cubes: ambiguous, fall back
    if data_idx is None:
        return None
    if stat_idx is not None:
        dd = [int(hdus[data_idx][0][f"NAXIS{i}"]) for i in (1, 2, 3)]
        ss = [int(hdus[stat_idx][0][f"NAXIS{i}"]) for i in (1, 2, 3)]
        if dd != ss:
            return None
    return hdus, data_idx, stat_idx


class IngestPlan:
    """A scanned, streamable cube file; :meth:`read` decodes it."""

    def __init__(self, filename, hdus, data_idx, stat_idx):
        self.filename = filename
        self._hdus = hdus
        self._data_idx = data_idx
        self._stat_idx = stat_idx
        hdr = hdus[data_idx][0]
        # FITS axes are x-fastest: NAXIS1=nx, NAXIS2=ny, NAXIS3=nz
        self.shape = (int(hdr["NAXIS3"]), int(hdr["NAXIS2"]),
                      int(hdr["NAXIS1"]))

    @property
    def has_var(self):
        """Whether the file has a STAT cube."""
        return self._stat_idx is not None

    @classmethod
    def scan(cls, filename):
        """An IngestPlan for ``filename``, or None when the layout does
        not support streaming (the caller falls back to ``Cube``)."""
        got = _streamable(filename)
        if got is None:
            return None
        return cls(filename, *got)

    def _read_payload(self, fh, idx, upload):
        """Decode one image payload in z-slabs; returns the host array."""
        hdr, offset, _ = self._hdus[idx]
        nz, ny, nx = self.shape
        dtype = np.dtype(np.float32 if int(hdr["BITPIX"]) == -32
                         else np.float64)
        plane = ny * nx * dtype.itemsize
        step = max(1, _SLAB_BYTES // plane)
        out = np.empty(self.shape, dtype)
        fh.seek(offset)
        for z0 in range(0, nz, step):
            z1 = min(nz, z0 + step)
            view = out[z0:z1]
            n = fh.readinto(memoryview(view).cast("B"))
            if n != view.nbytes:
                raise OSError(f"truncated FITS payload in {self.filename}")
            # the raw bytes are big-endian: swap in place (the view keeps
            # its native dtype, so no second buffer exists)
            view.byteswap(inplace=True)
            if upload is not None:
                upload(view if dtype.itemsize == 4
                       else view.astype(np.float32))
        return out

    def read(self, upload_data=None, upload_var=None):
        """Decode the cube, handing its slabs to the callbacks.

        ``upload_data`` / ``upload_var`` receive each float32 z-slab in
        order, right after its in-place byteswap, so that the copy of slab
        k runs while slab k+1 decodes.  Returns the host :class:`Cube`,
        with the content of ``Cube(filename)``: unfilled data and
        variance, the mask the data's non-finite pattern (stamped, so
        ``masked_invalid`` serves it without a scan).
        """
        with tracing.span("ingest.decode"), open(self.filename, "rb") as fh:
            data = self._read_payload(fh, self._data_idx, upload_data)
            var = None
            if self._stat_idx is not None:
                var = self._read_payload(fh, self._stat_idx, upload_var)

        with tracing.span("ingest.nonfinite"):
            m = ~np.isfinite(data)
            # mask=False: no mask, without a second scan of the data
            cube = Cube(data=data, var=var, mask=m if m.any() else False,
                        copy=False)
            cube._stamp_nonfinite_mask()
        cube.filename = self.filename
        cube.primary_header = self._hdus[0][0]
        hdr = self._hdus[self._data_idx][0]
        cube.data_header = hdr
        # the coordinates as containers._Base._load parses them
        cube.wcs = WCS.from_header(hdr, shape=self.shape[-2:])
        cube.wave = WaveCoord.from_header(hdr, axis=3, shape=self.shape[0])
        cube._sync_coord_shapes()
        return cube
