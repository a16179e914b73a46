"""Sessions in the reference ``muse_origin`` package's dialect.

The port's copy of :mod:`origin_tpu.pipeline.compat`.  The reference
writes its session parameters with an unrestricted YAML dumper, so its
``<name>.yaml`` carries ``!!python/...`` tags: per-step ``Status`` enums
(string-valued members such as ``'dumped outputs'``), numpy scalars for
interpolated thresholds, tuples for per-area lists.  ``yaml.safe_load``
refuses every one of those tags.

:func:`loads_params` reads the dialect with a ``SafeLoader`` subclass:
the tags whose payloads matter (Status, numpy scalars and dtypes, tuples,
OrderedDict) are decoded faithfully, any other python tag degrades to its
plain YAML payload with a warning, and the result is normalized into the
schema the session writes (step status as enum *names*, builtin scalars,
lists).  :func:`export_reference_session` goes the other way: dense
standard FITS products under the reference's file names and the
python-tagged parameter file.

PyYAML is imported inside the functions that need it (the loader and the
dumper classes are built at their first use), so the default session
write runs without it.
"""

from __future__ import annotations

import base64
import copy
import functools
import logging
import os

import numpy as np

__all__ = [
    "dumps_reference_params",
    "export_reference_session",
    "load_params",
    "loads_params",
    "looks_like_reference_yaml",
]

logger = logging.getLogger(__name__)

# Reference Status member values -> member names.  The session persists
# the *names*.
_REF_STATUS_VALUES = {
    "not run yet": "NOTRUN",
    "run": "RUN",
    "dumped outputs": "DUMPED",
    "failed": "FAILED",
}
_STATUS_NAMES = frozenset(_REF_STATUS_VALUES.values())
_STATUS_TO_REF = {v: k for k, v in _REF_STATUS_VALUES.items()}


def _status_name(arg):
    """Map a reference Status payload (value string, name, or ordinal)."""
    if isinstance(arg, str):
        if arg in _REF_STATUS_VALUES:
            return _REF_STATUS_VALUES[arg]
        if arg in _STATUS_NAMES:
            return arg
    if isinstance(arg, (int, np.integer)):
        # some dumpers persist the member by ordinal; Enum auto() ordinals
        # are 1-based (NOTRUN=1 .. FAILED=4)
        names = ["NOTRUN", "RUN", "DUMPED", "FAILED"]
        if 1 <= int(arg) <= len(names):
            return names[int(arg) - 1]
    raise ValueError(f"unrecognized reference Status payload: {arg!r}")


def _numpy_dtype(args, state):
    """Rebuild a dtype from numpy's __reduce__ payload."""
    dt = np.dtype(args[0]) if args else np.dtype("f8")
    if state:
        # state[1] is the byte order of the pickled dtype
        order = state[1] if len(state) > 1 else None
        if order in ("<", ">", "=", "|"):
            dt = dt.newbyteorder(order)
    return dt


def _numpy_scalar(args):
    """Decode ``numpy.core.multiarray.scalar(dtype, bytes)`` payloads."""
    dt, payload = args
    if not isinstance(dt, np.dtype):
        dt = np.dtype(dt)
    if isinstance(payload, str):
        payload = base64.b64decode(payload)
    return np.frombuffer(payload, dtype=dt)[0].item()


def _numpy_array(args, state):
    """Decode ``numpy[._]core.multiarray._reconstruct`` payloads.

    ``ndarray.__reduce__`` splits the array across the apply node:
    ``args = (subtype, (0,), b'b')`` and
    ``state = (version, shape, dtype, is_fortran, data)``.
    """
    if not state or len(state) < 5:
        raise ValueError("ndarray payload without a 5-tuple state")
    _, shape, dt, isfortran, payload = state[:5]
    if not isinstance(dt, np.dtype):
        dt = np.dtype(dt)
    if isinstance(payload, str):
        payload = base64.b64decode(payload)
    if isinstance(payload, (list, tuple)):
        # object arrays carry their elements as a list
        arr = np.array(payload, dtype=object)
    else:
        arr = np.frombuffer(payload, dtype=dt).copy()
    return arr.reshape(tuple(shape), order="F" if isfortran else "C")


def _apply(suffix, args, state, listitems=None, dictitems=None):
    """Best-effort evaluation of a ``python/object/apply:<suffix>`` node."""
    if suffix.endswith(".Status"):
        return _status_name(args[0])
    if suffix == "numpy.dtype":
        return _numpy_dtype(args, state)
    if suffix.endswith("multiarray.scalar"):
        return _numpy_scalar(args)
    if suffix.endswith("multiarray._reconstruct"):
        return _numpy_array(args, state)
    if suffix in ("builtins.tuple", "__builtin__.tuple"):
        return tuple(args[0]) if args else ()
    if suffix in ("builtins.list", "__builtin__.list"):
        if args:
            return list(args[0])
        return list(listitems) if listitems else []
    if suffix in ("builtins.dict", "__builtin__.dict",
                  "collections.OrderedDict"):
        # PyYAML < 5.1 dumps OrderedDict through represent_object, whose
        # contents arrive as listitems of (key, value) pairs
        if args:
            return dict(args[0])
        if dictitems:
            return dict(dictitems)
        return dict(listitems) if listitems else {}
    if suffix in ("builtins.set", "__builtin__.set"):
        if args:
            return list(args[0])
        return list(listitems) if listitems else []
    logger.warning(
        "reference session: unknown python tag %r degraded to its payload",
        suffix,
    )
    if state is not None:
        return state
    if dictitems:
        return dict(dictitems)
    if listitems:
        return list(listitems)
    if len(args) == 1:
        return args[0]
    return args or None


def _construct_apply(loader, suffix, node):
    import yaml

    if isinstance(node, yaml.SequenceNode):
        args = loader.construct_sequence(node, deep=True)
        state = listitems = dictitems = None
    elif isinstance(node, yaml.MappingNode):
        m = loader.construct_mapping(node, deep=True)
        args = m.get("args", [])
        state = m.get("state")
        listitems = m.get("listitems")
        dictitems = m.get("dictitems")
    else:
        args = [loader.construct_scalar(node)]
        state = listitems = dictitems = None
    return _apply(suffix, args, state, listitems, dictitems)


def _construct_payload(loader, node):
    """The plain YAML payload of a node."""
    import yaml

    if isinstance(node, yaml.MappingNode):
        return loader.construct_mapping(node, deep=True)
    if isinstance(node, yaml.SequenceNode):
        return loader.construct_sequence(node, deep=True)
    return loader.construct_scalar(node)


def _construct_object(loader, suffix, node):
    # a pickled instance: its payload is the __dict__ / state
    return _construct_payload(loader, node)


def _construct_name(loader, suffix, node):
    return suffix


def _construct_tuple(loader, node):
    return tuple(loader.construct_sequence(node, deep=True))


def _construct_python_other(loader, suffix, node):
    """Catch-all for python tags with no dedicated decoder: degrade to
    the plain YAML payload with a warning (never refuse the file)."""
    if suffix == "complex":
        try:
            return complex(loader.construct_scalar(node).strip("()"))
        except ValueError:
            pass
    logger.warning(
        "reference session: unsupported tag python/%s degraded to its "
        "payload", suffix,
    )
    return _construct_payload(loader, node)


@functools.cache
def _ref_loader():
    """The ``SafeLoader`` subclass that tolerates the reference's
    python-tagged YAML (built once, at the first read)."""
    import yaml

    class _RefLoader(yaml.SafeLoader):
        pass

    prefix = "tag:yaml.org,2002:"
    _RefLoader.add_multi_constructor(prefix + "python/object/apply:",
                                     _construct_apply)
    _RefLoader.add_multi_constructor(prefix + "python/object/new:",
                                     _construct_apply)
    _RefLoader.add_multi_constructor(prefix + "python/object:",
                                     _construct_object)
    _RefLoader.add_multi_constructor(prefix + "python/name:",
                                     _construct_name)
    _RefLoader.add_constructor(prefix + "python/tuple", _construct_tuple)
    # registered LAST: multi-constructor prefixes match in insertion
    # order, so the specific handlers above keep precedence
    _RefLoader.add_multi_constructor(prefix + "python/",
                                     _construct_python_other)
    safe = yaml.SafeLoader
    for tag, ctor in (
        ("python/str", safe.construct_yaml_str),
        ("python/unicode", safe.construct_yaml_str),
        ("python/int", safe.construct_yaml_int),
        ("python/long", safe.construct_yaml_int),
        ("python/float", safe.construct_yaml_float),
        ("python/bool", safe.construct_yaml_bool),
        ("python/none", safe.construct_yaml_null),
        ("python/list", safe.construct_yaml_seq),
        ("python/dict", safe.construct_yaml_map),
    ):
        _RefLoader.add_constructor(prefix + tag, ctor)
    return _RefLoader


def _normalize(obj):
    """Reduce a decoded reference tree to the session's plain-YAML
    schema."""
    if isinstance(obj, dict):
        return {k: _normalize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_normalize(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


def looks_like_reference_yaml(text):
    """Cheap sniff for the reference dumper's python tags."""
    return "!!python/" in text


def loads_params(text):
    """Parse a reference-dialect params YAML string into the session's
    schema."""
    import yaml

    return _normalize(yaml.load(text, Loader=_ref_loader()))


def load_params(path):
    """Read a reference-written ``<name>.yaml`` session parameter file."""
    with open(path) as f:
        return loads_params(f.read())


# -- the reference-readable session export ----------------------------------
#
# A session directory that the reference package's ``ORIGIN.load``
# accepts: dense standard FITS per product under the reference's file
# names, the testO2/histO2/binO2 text arrays, and a params YAML in the
# reference's python-tagged dialect (its loader calls ``yaml.unsafe_load``,
# and its ``Step.load`` only restores steps whose status IS the
# ``Status.DUMPED`` enum instance: a plain string would skip every step).


class _RefStatus:
    """Marker dumped as the reference's python-tagged Status enum."""

    def __init__(self, name):
        self.value = _STATUS_TO_REF[name]


def _repr_ref_status(dumper, data):
    return dumper.represent_sequence(
        "tag:yaml.org,2002:python/object/apply:muse_origin.steps.Status",
        [data.value],
    )


@functools.cache
def _ref_dumper():
    """``SafeDumper`` plus exactly the python tags the reference dialect
    needs (built once, at the first export)."""
    import yaml

    class _RefDumper(yaml.SafeDumper):
        pass

    _RefDumper.add_representer(_RefStatus, _repr_ref_status)
    return _RefDumper


def dumps_reference_params(param, step_names, dumped_steps=()):
    """Serialize a param tree in the reference's YAML dialect.

    ``step_names`` lists the per-step sub-dict keys; each one's
    ``status`` string becomes the python-tagged Status enum node.  Steps
    named in ``dumped_steps`` are forced to 'dumped outputs' (their
    product files exist in the export, so the reference must load them;
    the RUN-but-unparked state has no reference equivalent).
    """
    import yaml

    p = copy.deepcopy(param)
    for sname in step_names:
        meta = p.get(sname)
        if isinstance(meta, dict) and "status" in meta:
            status = meta["status"]
            status = getattr(status, "name", status)  # live enum or name
            if sname in dumped_steps and status in ("RUN", "DUMPED"):
                status = "DUMPED"
            meta["status"] = _RefStatus(status)
    # the reference's load indexes param["PSF"] unconditionally: default
    # to the non-file sentinel that routes it to the cube_psf.fits
    # discovery path
    p.setdefault("PSF", "")
    return yaml.dump(p, Dumper=_ref_dumper(), default_flow_style=False)


def _dense(arr):
    arr = np.asarray(arr)
    return arr.astype(np.float32) if arr.dtype == np.float64 else arr


def _host_data(val):
    """The host array of a product: a device cube's copy (not kept on the
    product), or the host object's data."""
    from .products import TensorCube

    if isinstance(val, TensorCube):
        return val.to_cube().data
    return val.data


def export_reference_session(orig, folder):
    """Write ``orig`` as a session directory the reference can load.

    Every product of a RUN/DUMPED step is written as a dense standard
    FITS/txt file under the reference's name, with the values the
    session's fetch gives: a parked product is fetched first, so recipe
    files are rebuilt and sparse extrema tables and scaled-int16 images
    decoded, and a device cube is copied to the host.  The instrument
    files (cube_psf/wfield/ima_white) and O2 diagnostic arrays are written
    as the reference's ``write`` does, and ``<name>.yaml`` uses the
    reference dialect above.  The directory loads in this package and in
    the JAX package too (their loaders sniff the dialect).
    """
    from ..core.containers import Cube, Image
    from .params import _sanitize
    from .spectra_io import save_spectra
    from .steps import Status

    os.makedirs(folder, exist_ok=True)
    name = os.path.basename(os.path.normpath(folder))

    # instrument files
    if getattr(orig, "PSF", None) is not None:
        psfs = orig.PSF if isinstance(orig.PSF, list) else [orig.PSF]
        for i, psf in enumerate(psfs):
            fn = ("cube_psf_%02d.fits" % i if isinstance(orig.PSF, list)
                  else "cube_psf.fits")
            Cube(data=_dense(psf), mask=False).write(os.path.join(folder, fn))
    if getattr(orig, "wfields", None) is not None:
        for i, wf in enumerate(orig.wfields):
            Image(data=_dense(np.asarray(wf)), mask=False).write(
                os.path.join(folder, "wfield_%02d.fits" % i))
    if getattr(orig, "ima_white", None) is not None:
        w = orig.ima_white
        Image(data=_dense(w.data), wcs=w.wcs).write(
            os.path.join(folder, "ima_white.fits"))

    dumped = []
    for step in orig.steps.values():
        if step.status not in (Status.RUN, Status.DUMPED):
            continue
        wrote = False
        for pname, kind in step.store.spec.items():
            val = step.store.fetch(pname)
            if val is None:
                continue
            path = step.store.file_for(pname, folder)
            if kind == "cube":
                var = getattr(val, "var", None)
                Cube(data=_dense(_host_data(val)),
                     var=None if var is None else _dense(var),
                     wcs=val.wcs, wave=val.wave).write(path)
            elif kind == "image":
                Image(data=_dense(val.data), wcs=val.wcs).write(path)
            elif kind == "table":
                val.write(path, overwrite=True)
            elif kind == "array":
                np.savetxt(path, np.atleast_1d(val))
            elif kind == "spectra":
                save_spectra(val, path)
            wrote = True
        if wrote:
            dumped.append(step.name)

    # per-area O2 diagnostics
    if getattr(orig, "nbAreas", None):
        for attr in ("testO2", "histO2", "binO2"):
            values = getattr(orig, attr, None)
            if values is not None:
                for area in range(1, orig.nbAreas + 1):
                    np.savetxt("%s/%s_%d.txt" % (folder, attr, area),
                               values[area - 1])

    text = dumps_reference_params(
        _sanitize(orig.param), list(orig.steps), dumped)
    with open(os.path.join(folder, f"{name}.yaml"), "w") as f:
        f.write(text)
    return folder
