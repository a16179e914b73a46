"""A small FITS writer and reader, frozen with the benchmark.

The writer lays a MUSE-like cube out as the survey's files have it: an
empty primary HDU with the FSF keywords (MUSE ``FSFMODE 2``: one model, or
one per field of a mosaic), then a ``DATA`` and a ``STAT`` image extension
of big-endian float32, each with the spatial WCS (``CD`` matrix, degrees)
and the wavelength axis (``AWAV``, Angstrom).  The cube is written from
the device in slabs of channels.  A mosaic's field map (0 where no field
covers a pixel, f + 1 where field f does) is a file of its own, one
primary int32 image.  The reader reads the image HDUs of a small file
(the profile dictionary, a mask) for the plain reference and the check.
"""

import numpy as np

BLOCK = 2880
CARD = 80


def _value(v):
    if isinstance(v, bool):
        return f"{'T' if v else 'F':>20}"
    if isinstance(v, (int, np.integer)):
        return f"{int(v):>20}"
    if isinstance(v, (float, np.floating)):
        s = repr(float(v)).upper()
        if "." not in s and "E" not in s:
            s += ".0"
        return f"{s:>20}"
    s = "'" + str(v).replace("'", "''").ljust(8) + "'"
    return f"{s:<20}"


def header_bytes(cards):
    """One header unit from ``(key, value)`` pairs, END and padding."""
    out = []
    for key, val in cards:
        out.append(f"{key:<8}= {_value(val)}".ljust(CARD)[:CARD])
    out.append("END".ljust(CARD))
    raw = "".join(out).encode("ascii")
    return raw + b" " * (-len(raw) % BLOCK)


def primary_cards(fsf, fields=None):
    """Primary header: no data, the FSF keywords: ``fsf``'s model as
    field 00, or with ``fields`` (a mosaic) one model per field, FSF00 to
    FSF<F-1>, all on ``fsf``'s wavelength range."""
    cards = [("SIMPLE", True), ("BITPIX", 8), ("NAXIS", 0), ("EXTEND", True),
             ("FSFMODE", 2), ("FSFLB1", float(fsf["lbrange"][0])),
             ("FSFLB2", float(fsf["lbrange"][1]))]
    for f, model in enumerate(fields or [fsf]):
        key = f"FSF{f:02d}"
        cards.append((f"{key}FNC", len(model["fwhm_pol"])))
        cards += [(f"{key}F{i:02d}", float(c))
                  for i, c in enumerate(model["fwhm_pol"])]
        cards.append((f"{key}BNC", len(model["beta_pol"])))
        cards += [(f"{key}B{i:02d}", float(c))
                  for i, c in enumerate(model["beta_pol"])]
    return cards


def image_cards(shape, geom, extname):
    """A float32 cube extension's header: WCS and wavelength axis."""
    nz, ny, nx = shape
    step = float(geom["pixstep_arcsec"]) / 3600.0
    ra, dec = geom["crval_radec"]
    return [("XTENSION", "IMAGE"), ("BITPIX", -32), ("NAXIS", 3),
            ("NAXIS1", nx), ("NAXIS2", ny), ("NAXIS3", nz), ("PCOUNT", 0),
            ("GCOUNT", 1), ("CRPIX1", nx / 2 + 1.0), ("CRPIX2", ny / 2 + 1.0),
            ("CRVAL1", float(ra)), ("CRVAL2", float(dec)),
            ("CTYPE1", "RA---TAN"), ("CTYPE2", "DEC--TAN"),
            ("CUNIT1", "deg"), ("CUNIT2", "deg"), ("CD1_1", -step),
            ("CD1_2", 0.0), ("CD2_1", 0.0), ("CD2_2", step),
            ("CRPIX3", 1.0), ("CRVAL3", float(geom["crval_wave"])),
            ("CD3_3", float(geom["cdelt_wave"])), ("CTYPE3", "AWAV"),
            ("CUNIT3", "Angstrom"), ("EXTNAME", extname)]


def _write_tensor(fh, t, slab):
    """A float32 tensor's big-endian bytes, byte-swapped on its device
    ``slab`` channels at a time, then the padding of its data unit."""
    import torch

    n = 0
    for z0 in range(0, t.shape[0], slab):
        part = t[z0:z0 + slab].contiguous().view(torch.uint8)
        part = part.reshape(-1, 4).flip(1).contiguous().cpu().numpy()
        fh.write(part.tobytes())
        n += part.size
    fh.write(b"\0" * (-n % BLOCK))


def write_cube(path, data, var, geom, fsf, slab=256, fields=None):
    """Write ``data`` and ``var`` (float32 tensors, (Nz, Ny, Nx)) as a
    MUSE-like FITS cube; ``fields``: a mosaic's FSF model per field."""
    with open(path, "wb") as fh:
        fh.write(header_bytes(primary_cards(fsf, fields)))
        for name, t in (("DATA", data), ("STAT", var)):
            fh.write(header_bytes(image_cards(tuple(t.shape), geom, name)))
            _write_tensor(fh, t, slab)


def write_fieldmap(path, fieldmap):
    """Write a (Ny, Nx) integer field map as the primary image of a FITS
    file, big-endian int32."""
    ny, nx = np.shape(fieldmap)
    raw = np.ascontiguousarray(fieldmap, dtype=">i4").tobytes()
    with open(path, "wb") as fh:
        fh.write(header_bytes([("SIMPLE", True), ("BITPIX", 32),
                               ("NAXIS", 2), ("NAXIS1", nx),
                               ("NAXIS2", ny)]))
        fh.write(raw + b"\0" * (-len(raw) % BLOCK))


def _parse(raw):
    out = {}
    for i in range(0, len(raw), CARD):
        card = raw[i:i + CARD].decode("ascii")
        key = card[:8].strip()
        if key == "END":
            return out, True
        if card[8:10] != "= ":
            continue
        val = card[10:].split("/")[0].strip() if "'" not in card[10:] \
            else card[10:].split("'")[1].rstrip()
        if val in ("T", "F"):
            val = val == "T"
        else:
            try:
                val = int(val)
            except ValueError:
                try:
                    val = float(val)
                except ValueError:
                    pass
        out[key] = val
    return out, False


def read_images(path):
    """``[(header dict, array or None), ...]`` of every HDU of a file of
    image HDUs."""
    dtypes = {8: ">u1", 16: ">i2", 32: ">i4", 64: ">i8", -32: ">f4",
              -64: ">f8"}
    hdus = []
    with open(path, "rb") as fh:
        while True:
            hdr, done = {}, False
            while not done:
                block = fh.read(BLOCK)
                if not block:
                    return hdus
                part, done = _parse(block)
                hdr.update(part)
            naxis = int(hdr.get("NAXIS", 0))
            shape = tuple(int(hdr[f"NAXIS{i}"]) for i in range(naxis, 0, -1))
            data = None
            if naxis:
                dt = np.dtype(dtypes[int(hdr["BITPIX"])])
                n = int(np.prod(shape))
                raw = fh.read(n * dt.itemsize)
                fh.read(-(n * dt.itemsize) % BLOCK)
                data = np.frombuffer(raw, dt).reshape(shape).astype(
                    dt.newbyteorder("="))
            hdus.append((hdr, data))
