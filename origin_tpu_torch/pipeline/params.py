"""The session's parameter file, written without a YAML library.

The JAX package writes the parameter tree with ``yaml.safe_dump``.  The
port writes the same tree as a YAML flow document in JSON syntax, which
``yaml.safe_load`` (and so both packages' ``load``) reads back to the same
tree: strings double-quoted with ASCII escapes, and floats spelled so that
PyYAML's YAML 1.1 resolver takes them as floats (a ``.`` and a signed
exponent: ``1.0e-05``, never ``1e-05``, which it reads as a string;
``.inf``, ``-.inf`` and ``.nan``).  Reading stays PyYAML's.
"""

from __future__ import annotations

import inspect
import math

import numpy as np

from .steps import Status

__all__ = ["dump_params"]


def _sanitize(obj):
    """Make the parameter tree safe-YAML serializable."""
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    if isinstance(obj, Status):
        return obj.name
    if isinstance(obj, (np.integer,)):
        return int(obj)
    if isinstance(obj, (np.floating,)):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    if isinstance(obj, (inspect.Parameter.empty.__class__,)):
        return None
    return obj


def _float(x):
    if math.isnan(x):
        return ".nan"
    if math.isinf(x):
        return ".inf" if x > 0 else "-.inf"
    mant, _, exp = repr(x).partition("e")
    if "." not in mant:
        mant += ".0"
    if exp and exp[0] not in "+-":
        exp = "+" + exp
    return f"{mant}e{exp}" if exp else mant


def _str(s):
    out = []
    for ch in s:
        code = ord(ch)
        if ch in '"\\':
            out.append("\\" + ch)
        elif 0x20 <= code < 0x7F:
            out.append(ch)
        elif code <= 0xFFFF:
            out.append("\\u%04x" % code)
        else:
            out.append("\\U%08x" % code)
    return '"' + "".join(out) + '"'


def _scalar(v):
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return _float(v)
    if isinstance(v, str):
        return _str(v)
    raise TypeError(f"cannot write {type(v).__name__} to the parameter "
                    f"file: {v!r}")


def _emit(v, indent):
    pad = "\n" + " " * (indent + 1)
    if isinstance(v, dict):
        if not v:
            return "{}"
        items = [f"{_scalar(k)}: {_emit(x, indent + 1)}" for k, x in v.items()]
        return "{" + pad + ("," + pad).join(items) + "}"
    if isinstance(v, list):
        if not v:
            return "[]"
        return "[" + ", ".join(_emit(x, indent + 1) for x in v) + "]"
    return _scalar(v)


def dump_params(tree):
    """The parameter tree (after :func:`_sanitize`) as the text of a YAML
    flow document that ``yaml.safe_load`` reads back equal."""
    return _emit(_sanitize(tree), 0) + "\n"
