"""Lightweight column-oriented table with FITS binary-table I/O.

(The port's copy of ``origin_tpu/core/table.py``, unchanged apart from this note.)

Replaces the subset of ``astropy.table.Table`` used by the reference catalogs
(Cat0..Cat3, Pval tables): column access, row access, sort, group_by, vstack,
join-on-key, meta propagation and FITS round-trips.  See reference
steps.py:931-1045 and lib_origin.py:1994-2222 for the operations exercised.
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from .. import fitsio

__all__ = ["Table", "vstack", "join"]


class Row:
    """A view on one table row."""

    __slots__ = ("_table", "_idx")

    def __init__(self, table, idx):
        self._table = table
        self._idx = idx

    def __getitem__(self, key):
        if isinstance(key, (list, tuple)):
            return tuple(self._table[k][self._idx] for k in key)
        return self._table[key][self._idx]

    def __setitem__(self, key, value):
        self._table[key][self._idx] = value

    @property
    def index(self):
        return self._idx

    def keys(self):
        return self._table.colnames

    def __repr__(self):
        vals = ", ".join(f"{k}={self[k]!r}" for k in self._table.colnames)
        return f"<Row {self._idx}: {vals}>"


class _Groups:
    def __init__(self, table, key_values, indices_per_group):
        self._table = table
        self.keys = key_values  # Table of unique key values
        self._indices = indices_per_group

    def __len__(self):
        return len(self._indices)

    def __iter__(self):
        for idx in self._indices:
            yield self._table[idx]

    def __getitem__(self, i):
        return self._table[self._indices[i]]

    def aggregate(self, func):
        """Aggregate every non-key column group-wise with ``func``."""
        keycols = self.keys.colnames
        out = Table()
        for k in keycols:
            out[k] = np.asarray(self.keys[k])
        import warnings

        for name in self._table.colnames:
            if name in keycols:
                continue
            with warnings.catch_warnings():
                # nan-aggregates over all-NaN groups are expected (e.g.
                # nanmax of STD for correl-only sources)
                warnings.simplefilter("ignore", category=RuntimeWarning)
                vals = [func(self._table[name][idx]) for idx in self._indices]
            out[name] = np.array(vals)
        out.meta.update(self._table.meta)
        return out


class _GroupedTable:
    def __init__(self, table, groups):
        self._table = table
        self.groups = groups


class Table:
    """Ordered mapping of column name -> 1-D numpy array."""

    def __init__(self, data=None, names=None, rows=None, meta=None, dtype=None):
        self.columns = OrderedDict()
        self.meta = dict(meta) if meta else {}
        self._formats = {}
        if rows is not None:
            if names is None:
                raise ValueError("rows requires names")
            cols = list(zip(*rows)) if len(rows) else [[] for _ in names]
            for i, name in enumerate(names):
                dt = None
                if dtype is not None:
                    dt = dtype[i]
                self.columns[name] = np.asarray(cols[i] if len(rows) else [], dtype=dt)
        elif data is not None:
            if isinstance(data, (dict, OrderedDict)):
                for k, v in data.items():
                    self.columns[k] = np.asarray(v)
            else:  # list of column arrays
                if names is None:
                    names = [f"col{i}" for i in range(len(data))]
                for name, col in zip(names, data):
                    self.columns[name] = np.asarray(col)

    # -- basic interface --------------------------------------------------
    @property
    def colnames(self):
        return list(self.columns.keys())

    def __len__(self):
        if not self.columns:
            return 0
        return len(next(iter(self.columns.values())))

    def __contains__(self, name):
        return name in self.columns

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.columns[key]
        if isinstance(key, (list, tuple)) and key and isinstance(key[0], str):
            t = Table()
            for k in key:
                t[k] = self.columns[k].copy()
            t.meta.update(self.meta)
            return t
        if isinstance(key, (int, np.integer)):
            return Row(self, int(key))
        # boolean mask / index array / slice
        t = Table()
        for k, v in self.columns.items():
            t[k] = v[key]
        t.meta.update(self.meta)
        t._formats.update(self._formats)
        return t

    def __setitem__(self, key, value):
        n = len(self)
        value = np.asarray(value)
        if value.ndim == 0:
            if n == 0 and self.columns:
                value = np.empty(0, dtype=value.dtype)
            else:
                value = np.full(max(n, 1) if self.columns else 1, value)
        if self.columns and len(value) != n:
            raise ValueError(f"column {key} has wrong length {len(value)} != {n}")
        self.columns[key] = value

    def __iter__(self):
        for i in range(len(self)):
            yield Row(self, i)

    def copy(self):
        t = Table()
        for k, v in self.columns.items():
            t[k] = v.copy()
        t.meta = dict(self.meta)
        t._formats = dict(self._formats)
        return t

    def filled(self):
        return self.copy()

    def set_format(self, name, fmt):
        self._formats[name] = fmt

    # -- column management -------------------------------------------------
    def add_column(self, col, name=None, index=None):
        if name is None:
            raise ValueError("name required")
        col = np.asarray(col)
        if index is None:
            self[name] = col
            return
        items = list(self.columns.items())
        self.columns = OrderedDict(items[:index] + [(name, col)] + items[index:])

    def add_columns(self, cols, names, indexes=None):
        if indexes is None:
            for c, n in zip(cols, names):
                self[n] = c
        else:
            # astropy semantics: indexes refer to positions in the ORIGINAL
            # column list; columns with equal index keep their given order.
            order = np.argsort(np.asarray(indexes), kind="stable")
            items = list(self.columns.items())
            inserted = 0
            for j in order:
                items.insert(int(indexes[j]) + inserted, (names[j], np.asarray(cols[j])))
                inserted += 1
            self.columns = OrderedDict(items)

    def remove_columns(self, names):
        if isinstance(names, str):
            names = [names]
        for n in names:
            self.columns.pop(n, None)
            self._formats.pop(n, None)

    def remove_column(self, name):
        self.remove_columns([name])

    def rename_column(self, old, new):
        items = [(new if k == old else k, v) for k, v in self.columns.items()]
        self.columns = OrderedDict(items)

    def add_row(self, row):
        if isinstance(row, dict):
            vals = [row.get(k) for k in self.colnames]
        else:
            vals = list(row)
        for k, v in zip(self.colnames, vals):
            col = self.columns[k]
            if v is None:
                v = np.nan if col.dtype.kind == "f" else 0
            self.columns[k] = np.append(col, np.asarray([v], dtype=col.dtype))

    # -- row operations ------------------------------------------------------
    def sort(self, keys):
        if isinstance(keys, str):
            keys = [keys]
        order = np.lexsort([np.asarray(self.columns[k]) for k in reversed(keys)])
        for k in self.colnames:
            self.columns[k] = self.columns[k][order]
        return order

    def argsort(self, keys):
        if isinstance(keys, str):
            keys = [keys]
        return np.lexsort([np.asarray(self.columns[k]) for k in reversed(keys)])

    def group_by(self, key):
        if isinstance(key, str):
            keycols = [key]
            keyvals = self.columns[key]
        elif isinstance(key, np.ndarray):
            keycols = None
            keyvals = key
        else:
            raise TypeError("group_by key must be a column name or array")
        order = np.argsort(keyvals, kind="stable")
        sorted_tbl = self[order]
        sorted_keys = np.asarray(keyvals)[order]
        uniq, starts = np.unique(sorted_keys, return_index=True)
        bounds = list(starts) + [len(sorted_keys)]
        indices = [np.arange(bounds[i], bounds[i + 1]) for i in range(len(uniq))]
        keys_tbl = Table()
        if keycols:
            keys_tbl[keycols[0]] = uniq
        else:
            keys_tbl["key"] = uniq
        grouped = _GroupedTable(sorted_tbl, _Groups(sorted_tbl, keys_tbl, indices))
        return grouped

    def loc(self, key_col, value):
        idx = np.where(self.columns[key_col] == value)[0]
        if len(idx) == 0:
            raise KeyError(f"{value!r} not found in column {key_col}")
        return Row(self, int(idx[0]))

    def as_array(self):
        dt = [(k, v.dtype) for k, v in self.columns.items()]
        out = np.empty(len(self), dtype=dt)
        for k, v in self.columns.items():
            out[k] = v
        return out

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame({k: v for k, v in self.columns.items()})

    # -- I/O -------------------------------------------------------------------
    def write(self, filename, overwrite=True):
        hdr = fitsio.Header()
        for k, v in self.meta.items():
            if isinstance(v, (str, int, float, bool, np.integer, np.floating)):
                hdr[str(k)[:8].upper()] = v
        hdu = fitsio.HDU(data=OrderedDict(self.columns), header=hdr)
        fitsio.write(filename, [fitsio.HDU(), hdu], overwrite=overwrite)

    @classmethod
    def read(cls, filename):
        hdus = fitsio.read(filename)
        for h in hdus:
            if isinstance(h.data, (dict, OrderedDict)):
                t = cls()
                for k, v in h.data.items():
                    t[k] = v
                skip = {"XTENSION", "BITPIX", "NAXIS", "NAXIS1", "NAXIS2", "PCOUNT",
                        "GCOUNT", "TFIELDS", "EXTNAME"}
                for k, v in h.header.items():
                    if k in skip or k.startswith(("TTYPE", "TFORM", "TUNIT")):
                        continue
                    t.meta[k] = v
                return t
        raise OSError(f"no binary table found in {filename}")

    def __repr__(self):
        head = " ".join(self.colnames)
        return f"<Table length={len(self)} cols=[{head}]>"

    def pformat(self, max_lines=30):
        names = self.colnames
        lines = ["  ".join(names)]
        for i in range(min(len(self), max_lines)):
            vals = []
            for k in names:
                v = self.columns[k][i]
                fmt = self._formats.get(k)
                vals.append(format(v, fmt) if fmt and not isinstance(v, str) else str(v))
            lines.append("  ".join(vals))
        return lines

    def __str__(self):
        return "\n".join(self.pformat())


def vstack(tables):
    """Stack tables vertically; missing columns are filled with NaN/0.

    Zero-length inputs keep their column structure (astropy semantics):
    stacking empty catalogs yields an empty catalog WITH columns, so
    downstream column access works on detection-free fields.
    """
    tables = [t for t in tables if t.colnames]
    if not tables:
        return Table()
    allnames = []
    for t in tables:
        for n in t.colnames:
            if n not in allnames:
                allnames.append(n)
    out = Table()
    for name in allnames:
        parts = []
        for t in tables:
            if name in t:
                parts.append(np.asarray(t[name]))
            else:
                ref = next(np.asarray(tt[name]) for tt in tables if name in tt)
                if ref.dtype.kind == "f":
                    parts.append(np.full(len(t), np.nan, dtype=ref.dtype))
                else:
                    parts.append(np.zeros(len(t), dtype=ref.dtype))
        out[name] = np.concatenate(parts)
    for t in tables:
        out.meta.update(t.meta)
    return out


def join(left, right, key="ID"):
    """Inner join of two tables on a single key column."""
    lk = np.asarray(left[key])
    rk = np.asarray(right[key])
    # positions of each left key in right
    out = Table()
    ridx = {v: i for i, v in enumerate(rk)}
    keep = [i for i, v in enumerate(lk) if v in ridx]
    rsel = [ridx[lk[i]] for i in keep]
    keep = np.asarray(keep, dtype=int)
    rsel = np.asarray(rsel, dtype=int)
    for name in left.colnames:
        out[name] = np.asarray(left[name])[keep]
    for name in right.colnames:
        if name == key or name in out:
            continue
        out[name] = np.asarray(right[name])[rsel]
    out.meta.update(left.meta)
    out.meta.update(right.meta)
    return out
