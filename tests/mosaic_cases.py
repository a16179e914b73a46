"""A small seeded mosaic cut from the benchmark's configuration
``muse_mosaic4_dico3`` (four fields, one Moffat FSF each, on the four
quadrants), and its single-field twin cut from ``muse_wfm_dico3``, made
and written by the benchmark's own generator and FITS writer.  Shared by
the CPU tests that hold the port's mosaic to the benchmark's plain
reference (tests/test_torch_mosaic_reference.py) and count step 05's
per-field spans (tests/test_torch_tracing.py).  numpy, torch, the port
and ``benchmark/`` only: nothing of JAX."""

import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {1: "muse_wfm_dico3", 4: "muse_mosaic4_dico3"}
SHAPE = (128, 40, 40)
# the benchmark's tiny mix: the dense mix's parameters with fewer sources
COUNTS = dict(n_cont=2, n_faint=6, n_bright=2)


def small_config(nfields):
    """The configuration of ``nfields`` (1 or 4) fields cut to
    ``SHAPE``, its field rectangles scaled with the spaxels."""
    with open(os.path.join(ROOT, "benchmark", "configs",
                           CONFIGS[nfields] + ".json")) as fh:
        conf = json.load(fh)
    _, ny, nx = conf["shape"]
    conf["shape"] = list(SHAPE)
    if "fieldmap" in conf:
        conf["fieldmap"] = [[y0 * SHAPE[1] // ny, y1 * SHAPE[1] // ny,
                             x0 * SHAPE[2] // nx, x1 * SHAPE[2] // nx]
                            for y0, y1, x0, x1 in conf["fieldmap"]]
    return conf


def small_traffic():
    with open(os.path.join(ROOT, "benchmark", "traffic", "dense.json")) as fh:
        mix = json.load(fh)
    mix.update(COUNTS)
    return mix


def write(path, nfields, seed):
    """Writes the field of ``seed`` (and a mosaic's field map) under
    ``path``; returns ``(cube_fn, fieldmap_fn or None, config,
    traffic)``."""
    from benchmark import field, fitsfile

    conf, mix = small_config(nfields), small_traffic()
    data, var, _ = field.make_field(conf, mix, seed, "cpu")
    cube_fn = os.path.join(str(path), "field.fits")
    fitsfile.write_cube(cube_fn, data, var, conf["geometry"], conf["fsf"],
                        fields=conf.get("fields"))
    fmap_fn = None
    if "fieldmap" in conf:
        fmap_fn = os.path.join(str(path), "fieldmap.fits")
        fitsfile.write_fieldmap(
            fmap_fn, (field.field_index(conf, "cpu") + 1).numpy())
    return cube_fn, fmap_fn, conf, mix


def session(path, nfields, seed, steps=8, **kw):
    """The port's session on the written field, through step ``steps``
    (at most 8) with the benchmark survey's parameters, on the CPU."""
    from origin_tpu_torch.pipeline.session import ORIGIN

    cube_fn, fmap_fn, conf, mix = write(path, nfields, seed)
    orig = ORIGIN.init(cube_fn, profiles=os.path.join(ROOT,
                                                      conf["dictionary"]),
                       fieldmap=fmap_fn, device="cpu", name="field",
                       path=str(path), loglevel="WARNING", **kw)
    for method, kwargs in conf["survey"][:steps]:
        getattr(orig, method)(**kwargs)
    return orig, conf, mix
