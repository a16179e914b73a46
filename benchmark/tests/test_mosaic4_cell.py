"""CPU tests of the mosaic cell ``muse_mosaic4_dico3.dense`` and of what
it adds to the harness, all of it new files: the configuration
``configs/muse_mosaic4_dico3.json``, the metrics ``glr_field_s`` and
``glr_spatial_roofline``, the readers ``readers/device_span.py`` and
``readers/span_roofline.py`` and the work module
``work/glr_spatial.py``.

- The cell resolves through ``spec.resolve`` to its files: four fields on
  four quadrants, the ``dense`` mix unchanged, the limits and survey of
  ``muse_wfm_dico3``, every per-layer metric of ``dense`` and the two
  new ones.
- Cut to 300 x 40 x 40, its field map and header cards are written by the
  harness and read back in the port.
- ``work/glr_spatial.py`` against a hand count, and against the matrix
  products that the port's chain performs (``FlopCounterMode``).
- The two readers on synthetic records, and with nothing to read.

    python -m pytest -q benchmark/tests
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
sys.path.insert(0, ROOT)

from benchmark import field, fitsfile, peaks, run, spec  # noqa: E402
from benchmark.readers import device_span, span_roofline  # noqa: E402
from benchmark.trace import Trace  # noqa: E402
from benchmark.work import glr_spatial  # noqa: E402
from origin_tpu_torch import tracing  # noqa: E402
from origin_tpu_torch.tracing import CountRecord, SpanRecord  # noqa: E402

CELL = "muse_mosaic4_dico3.dense"
DENSE = "muse_wfm_dico3.dense"
NEW_METRICS = {"glr_field_s", "glr_spatial_roofline"}
QUADRANTS = [[0, 150, 0, 150], [0, 150, 150, 300], [150, 300, 0, 150],
             [150, 300, 150, 300]]
# the keys in which the mosaic's file differs from the single field's
MOSAIC_KEYS = {"name", "what", "source", "fields", "fieldmap", "reduced",
               "published", "assumed"}


def _resolve(name):
    return spec.resolve(spec.load(ROOT), name, ROOT)


# -- the cell and its configuration ---------------------------------------
def test_the_cell_resolves_to_its_new_files():
    cell, conf, mix, e2e, per_layer = _resolve(CELL)
    _, dense_conf, dense_mix, dense_e2e, dense_layer = _resolve(DENSE)
    assert cell["chips"] == 1 and cell["traffic"] == "dense"
    assert mix == dense_mix
    assert [m["name"] for m in e2e] == [m["name"] for m in dense_e2e] == [
        "field_s", "peak_mem_gib", "setup_s"]
    names = {m["name"] for m in per_layer}
    assert names == {m["name"] for m in dense_layer} | NEW_METRICS
    for m in per_layer:
        if m["name"] in NEW_METRICS:
            assert m["workloads"] == [CELL] and m["moves"] == "field_s"
            assert m["layer"] == "GLR matched filter (step 05)"
    assert conf["fieldmap"] == QUADRANTS
    assert [f["fwhm_pol"] for f in conf["fields"]] == [
        [-0.2, 0.64], [-0.2, 0.68], [-0.2, 0.72], [-0.2, 0.76]]
    assert [f["beta_pol"] for f in conf["fields"]] == [[2.6], [2.7], [2.8],
                                                       [2.9]]
    index = field.field_index(conf, "cpu")
    assert sorted(torch.bincount(index.flatten()).tolist()) == [22500] * 4
    # everything but the mosaic's own keys is the single field's
    assert set(conf) - set(dense_conf) == {"fields", "fieldmap",
                                           "published"}
    for key in set(dense_conf) - MOSAIC_KEYS:
        assert conf[key] == dense_conf[key], key
    entry = next(c for c in spec.load(ROOT)["configs"]
                 if c["name"] == cell["config"])
    assert entry["reduced"] == conf["reduced"]
    assert len(entry["source"]) <= 200


def test_the_cell_writes_its_map_and_header_at_a_small_shape(tmp_path):
    """Cut to 300 x 40 x 40 (the rectangles scaled with the spaxels), the
    harness writes the mosaic's header cards and field map; the port reads
    back one model per field with the configuration's polynomials, and
    its weights equal the harness's."""
    from origin_tpu_torch import fitsio
    from origin_tpu_torch.core.fsf import FieldsMap, read_fsf_from_header

    _, conf, mix, _, _ = _resolve(CELL)
    conf = dict(conf, shape=[300, 40, 40], fieldmap=[
        [v * 40 // 300 for v in r] for r in conf["fieldmap"]])
    cards = dict(fitsfile.primary_cards(conf["fsf"], conf["fields"]))
    for f, model in enumerate(conf["fields"]):
        assert cards[f"FSF{f:02d}F01"] == model["fwhm_pol"][1]
        assert cards[f"FSF{f:02d}B00"] == model["beta_pol"][0]
    assert "FSF04FNC" not in cards
    survey = run.Survey.__new__(run.Survey)
    survey.config, survey.device = conf, "cpu"
    survey.cube_path = str(tmp_path / "field.fits")
    survey.fieldmap = str(tmp_path / "fieldmap.fits")
    survey.write(mix, 3230000123)
    models = read_fsf_from_header(fitsio.read(survey.cube_path)[0].header)
    assert [(list(m.fwhm_pol), list(m.beta_pol)) for m in models] == [
        (f["fwhm_pol"], f["beta_pol"]) for f in conf["fields"]]
    fmap = fitsfile.read_images(survey.fieldmap)[0][1]
    assert fmap.shape == (40, 40)
    assert [fmap[0, 0], fmap[0, 39], fmap[39, 0], fmap[39, 39]] == [1, 2, 3,
                                                                    4]
    got = FieldsMap(survey.fieldmap, nfields=4).compute_weights()
    assert np.array_equal(np.stack(got),
                          field.weight_maps(conf, "cpu").numpy())


# -- work/glr_spatial.py ----------------------------------------------------
def _small(nfields):
    conf = dict(shape=[10, 6, 8], psf_size=3)
    if nfields > 1:
        conf["fields"] = [{}] * nfields
    return conf


@pytest.mark.parametrize("nfields", [1, 2])
def test_glr_spatial_work_by_hand(nfields):
    # Nz 10, Ny 6, Nx 8, P 3: FY = 8, FX = 10, FXr = 6.  Per channel:
    # x-DFT 2 products of (6 x 8)(8 x 6) = 2 * 2 * 288; y-DFT 4 of
    # (8 x 6)(6 x 6) = 4 * 2 * 288; spectral product 6 * 48; inverse y 4
    # of (6 x 8)(8 x 6) = 4 * 2 * 288; inverse x 2 of (6 x 6)(6 x 8) =
    # 2 * 2 * 288: 1152 + 2304 + 288 + 2304 + 1152 = 7200.
    flops, nbytes, key = glr_spatial.count(_small(nfields), None)
    assert flops == nfields * 10 * 7200 and key == "fp32"
    # the cube read and the result written (2 * 480 floats), each field's
    # spectra bank (480 complex floats) and, for a mosaic, its weight map
    # (48 floats)
    weights = 0 if nfields == 1 else nfields * 48 * 4
    assert nbytes == 2 * 480 * 4 + nfields * 480 * 8 + weights


@pytest.mark.parametrize("nfields", [1, 2])
def test_glr_spatial_work_is_the_products_of_the_port_chain(nfields):
    """The matrix products of the port's chain (``glr_spatial_matmul``),
    counted by torch, are the work module's operations less the spectral
    product's six a frequency, at a shape whose padding is the least."""
    from torch.utils.flop_counter import FlopCounterMode

    from origin_tpu_torch.ops.convolve import fft2_shape
    from origin_tpu_torch.ops.glr import glr_spatial_matmul, spatial_operands

    conf = _small(nfields)
    _, nz, ny, nx, fy, fxr = glr_spatial.shapes(conf)
    assert fft2_shape((ny, nx), (3, 3)) == (fy, 2 * (fxr - 1))
    g = torch.Generator().manual_seed(1)
    psfs = torch.rand((nfields, nz, 3, 3), generator=g)
    wmaps = None if nfields == 1 else torch.rand((nfields, ny, nx),
                                                 generator=g)
    kern_r, kern_i, factors, _ = spatial_operands(psfs, wmaps, ny, nx,
                                                  (fy, 2 * (fxr - 1)))
    cube = torch.rand((nz, ny, nx), generator=g)
    with FlopCounterMode(display=False) as counter:
        glr_spatial_matmul(cube, kern_r, kern_i, wmaps, factors)
    flops, _, _ = glr_spatial.count(conf, None)
    assert counter.get_total_flops() == flops - nfields * nz * 6 * fy * fxr


def test_glr_spatial_work_at_the_cell():
    _, conf, _, _, _ = _resolve(CELL)
    assert glr_spatial.shapes(conf) == (4, 3681, 300, 300, 324, 163)
    flops, nbytes, _ = glr_spatial.count(conf, None)
    single = glr_spatial.count(_resolve(DENSE)[1], None)
    assert flops == 4 * single[0]
    # four banks of 3681 x 324 x 163 complex floats lead the bytes
    assert nbytes - single[1] == 3 * 3681 * 324 * 163 * 8 + 4 * 90000 * 4
    assert flops / peaks.PEAKS["fp32"] > nbytes / peaks.PEAKS["hbm_bytes"]


# -- readers/device_span.py and readers/span_roofline.py --------------------
S = 10 ** 9


def _span(name, a, b, index=None):
    return SpanRecord(name, a, b, "step05", 1,
                      {} if index is None else {"index": index})


SPANS = [
    _span("glr.field", 0, 500, 0),          # before the window
    _span("glr.field", 1000, 1300, 0),
    _span("glr.field", 1300, 1700, 1),
    _span("step05", 900, 2000),
    _span("glr.field", 9800, 10500, 0),      # across the window's end
]


@pytest.fixture
def program(monkeypatch):
    monkeypatch.setattr(tracing, "records", lambda: tracing.Records(
        list(SPANS), [CountRecord("glr.fields", 950, 2, 1)]))


def _ctx(trace=True, fields=2, config=None):
    return dict(trace=Trace([(1000, 1700, "k")], 1000, 10000) if trace
                else None, spans=None, fields=fields, config=config,
                profiles=None)


SPEC = dict(spans=["glr.field"], work="glr_spatial")


def test_device_span_sums_the_window_per_field(program):
    # the two spans inside [1000, 10000]: 300 + 400 ns over 2 fields
    assert device_span.read(_ctx(), SPEC) == 700 / S / 2


def test_span_roofline_is_the_least_time_over_the_spans(program):
    conf = _small(2)
    flops, nbytes, _ = glr_spatial.count(conf, None)
    least = max(flops / 67e12, nbytes / 3.35e12)
    got = span_roofline.read(_ctx(config=conf), SPEC)
    assert got == pytest.approx(100.0 * least / (700 / S / 2), rel=1e-12)


def test_the_readers_read_nothing_where_there_is_nothing(program,
                                                         monkeypatch):
    # no device trace (a run on the CPU, or --trace 0)
    assert device_span.read(_ctx(trace=False), SPEC) is None
    assert span_roofline.read(_ctx(trace=False, config=_small(2)),
                              SPEC) is None
    # a program without the span, as the parent of the cell's PR
    other = dict(SPEC, spans=["glr.other"])
    assert device_span.read(_ctx(), other) is None
    assert span_roofline.read(_ctx(config=_small(2)), other) is None
    late = dict(_ctx(), trace=Trace([], 20000, 30000))
    assert device_span.read(late, SPEC) is None
    monkeypatch.setitem(sys.modules, "origin_tpu_torch.tracing", None)
    assert device_span.read(_ctx(), SPEC) is None
    assert span_roofline.read(_ctx(config=_small(2)), SPEC) is None
