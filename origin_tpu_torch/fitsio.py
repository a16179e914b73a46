"""Minimal, dependency-free FITS reader/writer.

(The port's copy of the reading and writing half of ``origin_tpu/fitsio.py``,
and of its ``getheader`` and ``scan``.)

The reference pipeline (musevlt/origin) leans on astropy.io.fits and mpdaf for
all of its FITS I/O.  Neither is available in this environment, and the
rebuild only needs a well-defined subset of the standard, so we provide a
small, strict implementation here:

- primary / image extensions with BITPIX in {8, 16, 32, 64, -32, -64}
- binary table extensions with TFORM codes L, J, K, E, D and ``nA`` strings
- header cards for bool/int/float/string values with comments

Everything is big-endian on disk per the FITS standard and converted to
native-endian numpy arrays in memory.

Reference behaviour being replaced: astropy.io.fits usage in
origin.py:515-533 (profile dictionaries), steps.py:76-98 (spectra files) and
the mpdaf Cube/Image writers.
"""

from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np

__all__ = ["Header", "HDU", "read", "scan", "write", "getdata", "getheader"]

BLOCK = 2880
CARDLEN = 80

_BITPIX_TO_DTYPE = {
    8: np.dtype(">u1"),
    16: np.dtype(">i2"),
    32: np.dtype(">i4"),
    64: np.dtype(">i8"),
    -32: np.dtype(">f4"),
    -64: np.dtype(">f8"),
}
_DTYPE_TO_BITPIX = {
    "uint8": 8,
    "int8": 16,  # FITS has no signed byte; widened to int16 on write
    "uint16": 32,  # FITS image ints are signed; widened losslessly
    "uint32": 64,
    "uint64": 64,  # widened with a range check on write
    "bool": 8,
    "int16": 16,
    "int32": 32,
    "int64": 64,
    "float32": -32,
    "float64": -64,
}


class Header:
    """Ordered FITS header: mapping from keyword to value, with comments."""

    def __init__(self, cards=None):
        self._values = OrderedDict()
        self._comments = {}
        self.history = []
        self.comments_raw = []
        if cards:
            for item in cards:
                if len(item) == 3:
                    k, v, c = item
                else:
                    k, v = item
                    c = None
                self.set(k, v, c)

    # -- mapping interface ------------------------------------------------
    def __contains__(self, key):
        return key.upper() in self._values

    def __getitem__(self, key):
        return self._values[key.upper()]

    def __setitem__(self, key, value):
        if isinstance(value, tuple) and len(value) == 2:
            self.set(key, value[0], value[1])
        else:
            self.set(key, value)

    def __delitem__(self, key):
        key = key.upper()
        self._values.pop(key, None)
        self._comments.pop(key, None)

    def get(self, key, default=None):
        return self._values.get(key.upper(), default)

    def set(self, key, value, comment=None):
        key = key.upper()
        self._values[key] = value
        if comment is not None:
            self._comments[key] = comment

    def comment(self, key):
        return self._comments.get(key.upper(), "")

    def keys(self):
        return self._values.keys()

    def items(self):
        return self._values.items()

    def copy(self):
        h = Header()
        h._values = OrderedDict(self._values)
        h._comments = dict(self._comments)
        h.history = list(self.history)
        h.comments_raw = list(self.comments_raw)
        return h

    def update(self, other):
        if isinstance(other, Header):
            for k, v in other.items():
                self.set(k, v, other.comment(k) or None)
        else:
            for k, v in dict(other).items():
                self[k] = v

    def add_history(self, text):
        self.history.append(str(text))

    def __repr__(self):
        lines = [f"{k} = {v!r}" for k, v in self._values.items()]
        return "\n".join(lines)


def _format_value(value):
    """Format a python value into the 20-char FITS value field."""
    if value is None:
        # undefined card: blank value field (round-trips the None that
        # _parse_value returns for it, instead of the string 'None')
        return " " * 20
    if isinstance(value, (bool, np.bool_)):
        return ("T" if value else "F").rjust(20)
    if isinstance(value, (int, np.integer)):
        return str(int(value)).rjust(20)
    if isinstance(value, (float, np.floating)):
        s = repr(float(value))
        if "e" in s or "E" in s:
            s = f"{float(value):.16E}"
        return s.rjust(20)
    # string
    s = str(value).replace("'", "''")
    return f"'{s:<8}'"


def _format_card(key, value, comment=None):
    key = key.upper()[:8]
    if key in ("COMMENT", "HISTORY", ""):
        card = f"{key:<8}{str(value)[:72]}"
    else:
        val = _format_value(value)
        card = f"{key:<8}= {val}"
        if comment:
            card += f" / {comment}"
        if len(card) > CARDLEN and isinstance(value, str):
            # over-long string: use the FITS CONTINUE convention ('&'-
            # terminated chunks on follow-on CONTINUE cards) so nothing is
            # lost; the comment rides the last card when it fits
            return _long_string_cards(key, str(value), comment)
    return card[:CARDLEN].ljust(CARDLEN)


def _long_string_cards(key, value, comment=None):
    """Value card + CONTINUE cards for a string too long for one card."""
    escaped = value.replace("'", "''")
    avail = CARDLEN - 13  # prefix (10) + quotes (2) + continuation '&'
    chunks = []
    while True:
        take = escaped[:avail]
        if take.count("'") % 2 == 1:
            take = take[:-1]  # do not split an escaped quote pair
        chunks.append(take)
        escaped = escaped[len(take):]
        if not escaped:
            break
    cards = []
    last = len(chunks) - 1
    for i, chunk in enumerate(chunks):
        prefix = f"{key:<8}= " if i == 0 else "CONTINUE  "
        card = f"{prefix}'{chunk}{'&' if i < last else ''}'"
        if i == last and comment:
            # keep as much of the comment as fits (truncated rather than
            # dropped whole, matching the single-card writer's behavior)
            room = CARDLEN - len(card) - 3
            if room > 0:
                card += f" / {comment[:room]}"
        cards.append(card[:CARDLEN].ljust(CARDLEN))
    return "".join(cards)


def _parse_value(raw):
    raw = raw.strip()
    if raw.startswith("'"):
        # string value: find closing quote (handle escaped '')
        body = raw[1:]
        out = []
        i = 0
        while i < len(body):
            if body[i] == "'":
                if i + 1 < len(body) and body[i + 1] == "'":
                    out.append("'")
                    i += 2
                    continue
                break
            out.append(body[i])
            i += 1
        return "".join(out).rstrip()
    if raw == "T":
        return True
    if raw == "F":
        return False
    if raw == "":
        return None
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw.replace("D", "E").replace("d", "e"))
    except ValueError:
        return raw


def _read_header(fh):
    """Read header blocks from current position. Returns Header or None at EOF."""
    cards = []
    while True:
        block = fh.read(BLOCK)
        if len(block) == 0 and not cards:
            return None
        if len(block) < BLOCK:
            raise OSError("truncated FITS header")
        text = block.decode("ascii", errors="replace")
        done = False
        for i in range(0, BLOCK, CARDLEN):
            card = text[i : i + CARDLEN]
            if card.startswith("END") and card[3:8].strip() == "":
                done = True
                break
            cards.append(card)
        if done:
            break
    hdr = Header()
    last_key = None
    for card in cards:
        key = card[:8].strip()
        if not key:
            last_key = None
            continue
        if key in ("COMMENT", "HISTORY"):
            text = card[8:].strip()
            if key == "HISTORY":
                hdr.history.append(text)
            else:
                hdr.comments_raw.append(text)
            # per the FITS convention CONTINUE must immediately follow the
            # card it extends; an intervening card ends the continuation
            # (a later stray CONTINUE must not be glued onto last_key)
            last_key = None
            continue
        if key == "CONTINUE":
            # continuation of the previous card's '&'-terminated string
            value, comment = _split_value_comment(card[10:])
            prev = hdr.get(last_key) if last_key else None
            if isinstance(prev, str) and prev.endswith("&"):
                more = _parse_value(value)
                hdr.set(last_key, prev[:-1] + str(more), comment)
            continue
        if card[8:10] != "= ":
            last_key = None
            continue
        value, comment = _split_value_comment(card[10:])
        hdr.set(key, _parse_value(value), comment)
        last_key = key
    return hdr


def _split_value_comment(rest):
    """Split a card's value field from its comment (a '/' outside quotes)."""
    in_str = False
    for i, ch in enumerate(rest):
        if ch == "'":
            in_str = not in_str
        elif ch == "/" and not in_str:
            return rest[:i], rest[i + 1 :].strip()
    return rest, None


class HDU:
    """One FITS header-data unit."""

    def __init__(self, data=None, header=None, name=None):
        self.header = header if header is not None else Header()
        self.data = data
        if name is not None:
            self.header["EXTNAME"] = name

    @property
    def name(self):
        return self.header.get("EXTNAME", "")

    def __repr__(self):
        shape = None if self.data is None else getattr(self.data, "shape", None)
        return f"<HDU {self.name!r} shape={shape}>"


# ---------------------------------------------------------------------------
# binary tables
# ---------------------------------------------------------------------------

def _tform_to_dtype(tform):
    tform = tform.strip()
    repeat = ""
    i = 0
    while i < len(tform) and tform[i].isdigit():
        repeat += tform[i]
        i += 1
    code = tform[i:]
    n = int(repeat) if repeat else 1
    if code == "L":
        return np.dtype(">u1"), n, "bool"
    if code == "B":
        return np.dtype(">u1"), n, "int"
    if code == "I":
        return np.dtype(">i2"), n, "int"
    if code == "J":
        return np.dtype(">i4"), n, "int"
    if code == "K":
        return np.dtype(">i8"), n, "int"
    if code == "E":
        return np.dtype(">f4"), n, "float"
    if code == "D":
        return np.dtype(">f8"), n, "float"
    if code == "A":
        return np.dtype(f"S{n}"), 1, "str"
    raise ValueError(f"unsupported TFORM {tform!r}")


def _dtype_to_tform(dt, col):
    kind = dt.kind
    if kind == "b":
        return "L"
    if kind in "iu":
        size = dt.itemsize
        return {1: "B", 2: "I", 4: "J", 8: "K"}[size]
    if kind == "f":
        return {4: "E", 8: "D"}[dt.itemsize]
    if kind in "SU":
        if dt.kind == "U":
            maxlen = dt.itemsize // 4
        else:
            maxlen = dt.itemsize
        maxlen = max(1, maxlen)
        return f"{maxlen}A"
    raise ValueError(f"unsupported column dtype {dt} for {col}")


def _read_bintable(hdr, raw):
    nrows = int(hdr["NAXIS2"])
    tfields = int(hdr["TFIELDS"])
    names, dtypes, kinds = [], [], []
    for i in range(1, tfields + 1):
        names.append(str(hdr.get(f"TTYPE{i}", f"col{i}")).strip())
        dt, n, kind = _tform_to_dtype(str(hdr[f"TFORM{i}"]))
        if n != 1 and kind != "str":
            dt = np.dtype((dt, (n,)))
        dtypes.append(dt)
        kinds.append(kind)
    rec_dt = np.dtype({"names": names, "formats": dtypes})
    arr = np.frombuffer(raw[: rec_dt.itemsize * nrows], dtype=rec_dt)
    cols = OrderedDict()
    for name, kind in zip(names, kinds):
        col = arr[name]
        if kind == "bool":
            # FITS logical: 'T'/'F' bytes
            cols[name] = col == ord("T")
        elif kind == "str":
            cols[name] = np.array([s.decode("ascii", "replace").rstrip() for s in col])
        else:
            cols[name] = np.ascontiguousarray(col).astype(col.dtype.newbyteorder("="))
    return cols


def _write_bintable(columns, header):
    """columns: OrderedDict name -> 1-D numpy array. Returns (header, bytes)."""
    names = list(columns.keys())
    arrays = []
    tforms = []
    for name in names:
        a = np.asarray(columns[name])
        if a.dtype.kind == "U":
            maxlen = max(1, a.dtype.itemsize // 4)
            a = np.char.encode(a.astype(f"U{maxlen}"), "ascii", "replace")
        if a.dtype.kind == "u" and a.dtype.itemsize > 1:
            # FITS table integers beyond 'B' are signed: widen unsigned
            # columns so large values survive the round-trip
            if a.dtype.itemsize == 8:
                if a.size and a.max() > np.iinfo(np.int64).max:
                    raise ValueError(
                        f"uint64 column {name!r} exceeds the FITS signed "
                        "64-bit range"
                    )
                a = a.astype(np.int64)
            else:
                a = a.astype(f"i{a.dtype.itemsize * 2}")
        # vector column (nrows, n): TFORM carries the repeat count so
        # NAXIS1 and the declared row layout agree (readers reconstruct
        # the width from it, _tform_to_dtype above)
        rep = int(np.prod(a.shape[1:])) if a.ndim > 1 else 1
        if a.dtype.kind == "b":
            tforms.append("L" if rep == 1 else f"{rep}L")
            a = np.where(a, ord("T"), ord("F")).astype("u1")
        else:
            tf = _dtype_to_tform(a.dtype, name)
            if rep != 1:
                if tf.endswith("A"):
                    raise ValueError(
                        f"vector string column {name!r} is not supported"
                    )
                tf = f"{rep}{tf}"
            tforms.append(tf)
            a = a.astype(a.dtype.newbyteorder(">"))
        arrays.append(a)
    nrows = len(arrays[0]) if arrays else 0
    rec_dt = np.dtype(
        {"names": names, "formats": [(a.dtype, a.shape[1:]) for a in arrays]}
    )
    rec = np.empty(nrows, dtype=rec_dt)
    for name, a in zip(names, arrays):
        rec[name] = a
    hdr = Header()
    hdr.set("XTENSION", "BINTABLE", "binary table extension")
    hdr.set("BITPIX", 8)
    hdr.set("NAXIS", 2)
    hdr.set("NAXIS1", rec_dt.itemsize)
    hdr.set("NAXIS2", nrows)
    hdr.set("PCOUNT", 0)
    hdr.set("GCOUNT", 1)
    hdr.set("TFIELDS", len(names))
    for i, (name, tform) in enumerate(zip(names, tforms), start=1):
        hdr.set(f"TTYPE{i}", name)
        hdr.set(f"TFORM{i}", tform)
    if header is not None:
        for k, v in header.items():
            if k in ("XTENSION", "BITPIX", "NAXIS", "NAXIS1", "NAXIS2", "PCOUNT",
                     "GCOUNT", "TFIELDS") or k.startswith(("TTYPE", "TFORM")):
                continue
            hdr.set(k, v, header.comment(k) or None)
        hdr.history.extend(header.history)
        hdr.comments_raw.extend(header.comments_raw)
    return hdr, rec.tobytes()


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def scan(filename):
    """Headers and payload byte offsets of every HDU; no payload is read.

    Returns a list of ``(header, data_offset, data_nbytes)`` tuples (the
    offset of the first payload byte and its unpadded length; 0 bytes for
    headerless HDUs), so that a streaming reader (``pipeline.ingest``)
    can read an image payload region by region.
    """
    out = []
    with open(filename, "rb") as fh:
        while True:
            hdr = _read_header(fh)
            if hdr is None:
                break
            naxis = int(hdr.get("NAXIS", 0))
            dims = [int(hdr[f"NAXIS{i}"]) for i in range(1, naxis + 1)]
            nelem = int(np.prod(dims)) if dims else 0
            if str(hdr.get("XTENSION", "")).strip() == "BINTABLE":
                nbytes = int(hdr["NAXIS1"]) * int(hdr["NAXIS2"]) + int(
                    hdr.get("PCOUNT", 0)
                )
            elif naxis == 0 or nelem == 0:
                nbytes = 0
            else:
                nbytes = nelem * _BITPIX_TO_DTYPE[int(hdr["BITPIX"])].itemsize
            out.append((hdr, fh.tell(), nbytes))
            fh.seek(_padded(nbytes), 1)
    if not out:
        raise OSError(f"empty FITS file: {filename}")
    return out


def read(filename):
    """Read all HDUs of a FITS file. Returns list of HDU objects."""
    hdus = []
    with open(filename, "rb") as fh:
        first = True
        while True:
            hdr = _read_header(fh)
            if hdr is None:
                break
            xtension = str(hdr.get("XTENSION", "")).strip()
            naxis = int(hdr.get("NAXIS", 0))
            dims = [int(hdr[f"NAXIS{i}"]) for i in range(1, naxis + 1)]
            nelem = int(np.prod(dims)) if dims else 0
            scale16 = None
            if xtension == "BINTABLE":
                nbytes = int(hdr["NAXIS1"]) * int(hdr["NAXIS2"]) + int(
                    hdr.get("PCOUNT", 0)
                )
                raw = fh.read(_padded(nbytes))[:nbytes]
                data = _read_bintable(hdr, raw)
            elif naxis == 0 or nelem == 0:
                data = None
            else:
                dtype = _BITPIX_TO_DTYPE[int(hdr["BITPIX"])]
                nbytes = nelem * dtype.itemsize
                raw = fh.read(_padded(nbytes))[:nbytes]
                data = np.frombuffer(raw, dtype=dtype).reshape(dims[::-1])
                data = data.astype(dtype.newbyteorder("="))
                bscale = hdr.get("BSCALE", 1)
                bzero = hdr.get("BZERO", 0)
                if bscale != 1 or bzero != 0:
                    # canonical unsigned-integer encodings stay integral;
                    # anything else scales in float64 (also avoids numpy 2
                    # NEP-50 overflow of e.g. int16 + 32768)
                    if bscale == 1 and bzero == 32768 and data.dtype == np.int16:
                        data = (data.astype(np.int32) + 32768).astype(np.uint16)
                    elif (bscale == 1 and bzero == 2147483648
                          and data.dtype == np.int32):
                        data = (data.astype(np.int64) + 2147483648).astype(
                            np.uint32
                        )
                    else:
                        # <=2-byte integers with no offset scale exactly
                        # in float32 — decoding a scaled int16 cube in
                        # float64 would double its memory for no
                        # precision.  Files with a BZERO offset (foreign
                        # conventions) keep the exact float64 path.
                        if data.dtype.itemsize <= 2 and bzero == 0:
                            if data.dtype == np.int16:
                                scale16 = float(bscale)
                            data = data.astype(np.float32)
                            data *= np.float32(bscale)
                        else:
                            data = data * float(bscale) + float(bzero)
                    # scaling is applied: strip the cards so a re-write does
                    # not double-scale
                    for card in ("BSCALE", "BZERO"):
                        if card in hdr:
                            del hdr[card]
            hdu = HDU(data=data, header=hdr)
            # the BSCALE of a scaled-int16 image (its card is stripped
            # above): a reader that keeps it can store the decoded values
            # again as the same integers (containers._Base._load)
            hdu.scale16 = scale16
            hdus.append(hdu)
            first = False
        if first:
            raise OSError(f"empty FITS file: {filename}")
    return hdus


def _padded(n):
    return ((n + BLOCK - 1) // BLOCK) * BLOCK


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _header_bytes(hdr, primary, data, xtension=None):
    cards = []
    naxis_dims = []
    if data is not None and not isinstance(data, (dict, OrderedDict)):
        naxis_dims = list(data.shape[::-1])
    if primary:
        cards.append(_format_card("SIMPLE", True, "conforms to FITS standard"))
    else:
        cards.append(_format_card("XTENSION", xtension or "IMAGE", "extension type"))
    if data is None or isinstance(data, (dict, OrderedDict)):
        bitpix = 8
    else:
        bitpix = _DTYPE_TO_BITPIX[data.dtype.name]
    cards.append(_format_card("BITPIX", bitpix, "array data type"))
    cards.append(_format_card("NAXIS", len(naxis_dims), "number of array dimensions"))
    for i, d in enumerate(naxis_dims, start=1):
        cards.append(_format_card(f"NAXIS{i}", d))
    if primary:
        cards.append(_format_card("EXTEND", True))
    else:
        cards.append(_format_card("PCOUNT", 0, "number of parameters"))
        cards.append(_format_card("GCOUNT", 1, "number of groups"))
    reserved = {"SIMPLE", "XTENSION", "BITPIX", "NAXIS", "EXTEND", "PCOUNT", "GCOUNT"}
    reserved |= {f"NAXIS{i}" for i in range(1, 10)}
    if hdr is not None:
        for k, v in hdr.items():
            if k in reserved:
                continue
            cards.append(_format_card(k, v, hdr.comment(k) or None))
        for text in hdr.history:
            cards.append(_format_card("HISTORY", text))
        for text in hdr.comments_raw:
            cards.append(_format_card("COMMENT", text))
    cards.append("END".ljust(CARDLEN))
    text = "".join(cards)
    pad = (-len(text)) % BLOCK
    return (text + " " * pad).encode("ascii")


def _data_bytes(data):
    """Return (payload, padding) buffers for one image HDU's data unit."""
    if data is None:
        return b"", b""
    dt = data.dtype
    if dt.name == "bool":
        data = data.astype("uint8")
        dt = data.dtype
    elif dt.name == "int8":
        data = data.astype("int16")
        dt = data.dtype
    elif dt.name == "uint16":
        data = data.astype("int32")
        dt = data.dtype
    elif dt.name == "uint32":
        data = data.astype("int64")
        dt = data.dtype
    elif dt.name == "uint64":
        if data.size and data.max() > np.iinfo(np.int64).max:
            raise ValueError("uint64 image exceeds the FITS signed range")
        data = data.astype("int64")
        dt = data.dtype
    bitpix = _DTYPE_TO_BITPIX[dt.name]
    target = _BITPIX_TO_DTYPE[bitpix]
    # exactly one copy in the common case (the big-endian byteswap); the
    # array itself is handed to the writer as a zero-copy memoryview —
    # cube-sized products make .tobytes()/join() round-trips expensive
    if dt != target:
        data = data.astype(target)
    data = np.ascontiguousarray(data)
    pad = (-data.nbytes) % BLOCK
    return memoryview(data).cast("B"), b"\0" * pad


def write(filename, hdus, overwrite=True):
    """Write a list of HDU objects to a FITS file.

    HDU.data may be None (empty), an ndarray (image), or an OrderedDict of
    1-D arrays (binary table).
    """
    if os.path.exists(filename) and not overwrite:
        raise OSError(f"{filename} exists")
    parts = []
    for i, hdu in enumerate(hdus):
        primary = i == 0
        data = hdu.data
        if isinstance(data, (dict, OrderedDict)):
            if primary:
                # tables cannot be primary HDUs: prepend an empty primary
                parts.append(_header_bytes(Header(), True, None))
                primary = False
            thdr, raw = _write_bintable(data, hdu.header)
            text_cards = [
                _format_card(k, v, thdr.comment(k) or None) for k, v in thdr.items()
            ]
            for t in thdr.history:
                text_cards.append(_format_card("HISTORY", t))
            for t in thdr.comments_raw:
                text_cards.append(_format_card("COMMENT", t))
            text_cards.append("END".ljust(CARDLEN))
            text = "".join(text_cards)
            pad = (-len(text)) % BLOCK
            parts.append((text + " " * pad).encode("ascii"))
            parts.append(raw + b"\0" * ((-len(raw)) % BLOCK))
        else:
            if data is not None:
                data = np.asarray(data)
            parts.append(_header_bytes(hdu.header, primary, data,
                                       xtension="IMAGE"))
            payload, padding = _data_bytes(data)
            parts.append(payload)
            parts.append(padding)
    # stream the parts: image payloads are zero-copy array views, and a
    # join() would re-copy every cube-sized buffer.  Write straight to
    # the final name (mpdaf/astropy semantics): a tmp+rename would make
    # ext4 flush the data pages synchronously on the rename
    # (auto_da_alloc), turning every product write into a disk wait on
    # the writer's critical path
    with open(filename, "wb") as fh:
        for part in parts:
            if len(part):
                fh.write(part)


# ---------------------------------------------------------------------------
# convenience helpers
# ---------------------------------------------------------------------------

def _data_unit_bytes(hdr):
    """Size of the (unpadded) data unit that follows ``hdr``."""
    naxis = int(hdr.get("NAXIS", 0))
    dims = [int(hdr[f"NAXIS{i}"]) for i in range(1, naxis + 1)]
    nelem = int(np.prod(dims)) if dims else 0
    if str(hdr.get("XTENSION", "")).strip() == "BINTABLE":
        return int(hdr["NAXIS1"]) * int(hdr["NAXIS2"]) + int(
            hdr.get("PCOUNT", 0))
    if naxis == 0 or nelem == 0:
        return 0
    return nelem * _BITPIX_TO_DTYPE[int(hdr["BITPIX"])].itemsize


def getheader(filename, ext=0):
    """Header of one HDU, seeking past data units instead of reading
    them (recipes/session restores probe GB-scale cube files for one
    primary keyword)."""
    with open(filename, "rb") as fh:
        i = 0
        while True:
            hdr = _read_header(fh)
            if hdr is None:
                if i == 0:
                    raise OSError(f"empty FITS file: {filename}")
                if isinstance(ext, str):
                    raise KeyError(
                        f"extension {ext!r} not found in {filename}")
                raise IndexError(f"no extension {ext} in {filename}")
            if isinstance(ext, str):
                if str(hdr.get("EXTNAME", "")).strip() == ext:
                    return hdr
            elif i == ext:
                return hdr
            fh.seek(_padded(_data_unit_bytes(hdr)), 1)
            i += 1


def getdata(filename, ext=None):
    hdus = read(filename)
    if ext is None:
        for h in hdus:
            if h.data is not None:
                return h.data
        return None
    if isinstance(ext, str):
        for h in hdus:
            if h.name == ext:
                return h.data
        raise KeyError(f"extension {ext!r} not found in {filename}")
    return hdus[ext].data
