"""The port's tracer (``origin_tpu_torch/tracing.py``) on the CPU, and one
``gpu`` test on the card.

- The tracer alone: off, a span is the shared no-op context and nothing is
  kept; on (under a CPU ``torch.profiler`` profile), spans nest with their
  parents, inherit their field, and counters add up.
- With no profiler, a minicube session through steps 01-10 records
  nothing and still sets each step's ``meta["runtime"]``.
- Under a CPU profile, the same session records the spans of the table in
  ``PERF.md`` section 3 with their parents and one field id per session;
  Σ ``greedy.nuisance_columns`` equals ``mapO2.sum()``, and
  ``greedy.iterations`` the iterations the areas ran, Σ
  ``greedy.power_columns`` the columns of the blocks the power iterations
  read (also on one area, on and off); ``lines.chunk``
  spans number ⌈Cat1 lines / 64⌉; ``timestat``'s total equals the step
  spans.
- Step 05 of a small mosaic (``tests/mosaic_cases.py``; F = 4 fields and
  its single-field twin): under a CPU profile one ``glr.field`` span per
  field, indices 0 to F - 1 in order, inside ``step05``, each waiting for
  the device at both ends, and the counters ``glr.fields`` (F) and
  ``glr.bank_bytes`` (the FSF spectra bank's bytes); with no profiler
  nothing is recorded and nothing waits for a device.
- ``gpu``: a span around a sweep launch under a CUDA-only profile brackets
  that kernel's interval in the profile, on the same clock.

The file imports nothing of JAX, so the ``gpu`` test runs on the card with
``python -m pytest -p no:cacheprovider --noconftest -m gpu
tests/test_torch_tracing.py``.
"""

import collections
import contextlib
import datetime
import math

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from origin_tpu_torch import tracing
from origin_tpu_torch.ops import pca

torch.set_num_threads(2)

STEPS = [f"step{i:02d}" for i in range(1, 11)]
# each span of a session through steps 01-10 and its parent
PARENTS = {
    "init": None,
    "ingest.decode": "init",
    "ingest.nonfinite": "init",
    "ingest.fsf": "init",
    "ingest.white": "init",
    "preprocess.device": "step01",
    "preprocess.join": "preprocess.device",
    "preprocess.segmentation": "step01",
    "greedy.area": "step04",
    "greedy.iteration": "greedy.area",
    "glr.field": "step05",
    "purity.segmap": "step06",
    "purity.counts": "step06",
    "lines.chunk": "step08",
    "masks.write": "step10",
    "engine.release": None,
    **dict.fromkeys(STEPS),
}


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _steps(orig, seg_fn):
    orig.step01_preprocessing()
    orig.step02_areas(minsize=30, maxsize=60)
    orig.step03_compute_PCA_threshold()
    orig.step04_compute_greedy_PCA()
    orig.step05_compute_TGLR()
    orig.step06_compute_purity_threshold(purity=0.8)
    orig.step07_detection(segmap=seg_fn)
    orig.step08_compute_spectra()
    orig.step09_clean_results()
    orig.step10_create_masks()
    return orig


@pytest.fixture(scope="module")
def sessions(tmp_path_factory):
    """The minicube through steps 01-10, off and then under a CPU profile,
    with the power iterations of step 04 and their blocks' columns kept in
    the traced one."""
    from origin_tpu_torch.pipeline.session import ORIGIN
    from tools_torch.synthetic import make_minicube, make_segmap

    path = tmp_path_factory.mktemp("tracing")
    cube_fn, seg_fn = str(path / "minicube.fits"), str(path / "segmap.fits")
    make_minicube(cube_fn)
    make_segmap(seg_fn)
    kw = dict(path=str(path), loglevel="WARNING", device="cpu")
    tracing.clear()
    off = _steps(ORIGIN.init(cube_fn, name="off", **kw), seg_fn)
    off_records = tracing.records()
    calls = []
    real = pca.rank1_left_vector
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pca, "rank1_left_vector",
                   lambda m: calls.append(m.shape[1]) or real(m))
        with _cpu_profile():
            on = _steps(ORIGIN.init(cube_fn, name="on", **kw), seg_fn)
            faint = np.array(on.cube_faint.data)
            on.engine.release()
    yield dict(off=off, off_records=off_records, on=on, faint=faint,
               records=tracing.records(), power_iterations=len(calls),
               power_columns=calls)
    tracing.clear()
    off.close_logfile()
    on.close_logfile()


# -- the tracer alone ---------------------------------------------------
def test_off_a_span_is_the_shared_no_op_and_nothing_is_kept():
    tracing.clear()
    assert not tracing.enabled()
    a, b = tracing.span("x", k=1), tracing.span("y")
    assert a is b
    with a:
        tracing.count("c", 3)
    with tracing.step_span("step01", "cpu") as sp:
        pass
    assert sp.elapsed_s >= 0 and sp.end_ns >= sp.start_ns
    assert tracing.records() == ([], [])


def test_on_spans_nest_inherit_their_field_and_count():
    tracing.clear()
    field = tracing.new_field()
    assert tracing.new_field() == field + 1
    with _cpu_profile():
        assert tracing.enabled()
        with tracing.step_span("step04", "cpu", field=field) as outer:
            with tracing.span("greedy.area", area=1):
                tracing.count("greedy.iterations")
                tracing.count("greedy.iterations", 2)
            with tracing.span("loose", field=field + 7):
                pass
        tracing.count("orphan", 5)
    spans, counts = tracing.records()
    by = {s.name: s for s in spans}
    assert [s.name for s in spans] == ["greedy.area", "loose", "step04"]
    assert by["greedy.area"].parent == "step04"
    assert by["greedy.area"].field == field
    assert by["greedy.area"].attrs == {"area": 1}
    assert by["loose"].field == field + 7
    assert by["step04"].parent is None
    assert by["step04"].attrs == {}  # no device memory read on the CPU
    assert (by["step04"].start_ns <= by["greedy.area"].start_ns
            <= by["greedy.area"].end_ns <= by["step04"].end_ns)
    assert outer.elapsed_s == (by["step04"].end_ns
                               - by["step04"].start_ns) / 1e9
    assert [(c.name, c.n, c.field) for c in counts] == [
        ("greedy.iterations", 1, field), ("greedy.iterations", 2, field),
        ("orphan", 5, None)]
    tracing.clear()
    assert tracing.records() == ([], [])


def test_a_failing_step_span_is_kept_and_reraises():
    tracing.clear()
    with _cpu_profile(), pytest.raises(ValueError):
        with tracing.step_span("step05", "cpu"):
            raise ValueError("inside")
    (rec,), _ = tracing.records()
    assert rec.name == "step05" and rec.end_ns >= rec.start_ns
    tracing.clear()


# -- a session ----------------------------------------------------------
def test_off_a_session_records_nothing_and_sets_runtime(sessions):
    assert sessions["off_records"] == ([], [])
    for step in sessions["off"].steps.values():
        if step.idx <= 10:
            assert step.meta["runtime"] > 0, step.method_name


def test_on_a_session_records_the_spans_with_their_parents(sessions):
    spans = sessions["records"].spans
    got = collections.Counter((s.name, s.parent) for s in spans)
    assert set(got) == set(PARENTS.items())
    for name in ["init"] + STEPS + ["ingest.decode", "preprocess.join",
                                     "purity.counts", "engine.release"]:
        assert got[name, PARENTS[name]] == 1, name
    assert {s.field for s in spans} == {sessions["on"].trace_field}
    assert sessions["on"].trace_field != sessions["off"].trace_field
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            outer = [p for p in spans if p.name == s.parent
                     and p.start_ns <= s.start_ns and s.end_ns <= p.end_ns]
            assert outer, (s.name, s.parent)


def test_greedy_counters_match_mapo2_and_the_iterations(sessions):
    on = sessions["on"]
    spans, counts = sessions["records"]
    total = collections.Counter()
    for c in counts:
        total[c.name] += c.n
    mapo2 = np.asarray(on.mapO2.data)
    assert total["greedy.nuisance_columns"] == int(mapo2.sum()) > 0
    # an area's loop runs one power iteration per greedy iteration, but
    # the last: it ends where no column is left (no power iteration
    # then), or at a break after its count (npyp == 1, itermax)
    power = sessions["power_iterations"]
    assert sum(s.name == "greedy.iteration" for s in spans) == power > 0
    faint = sessions["faint"]
    faint = faint.reshape(faint.shape[0], -1)
    areamap = np.asarray(on.areamap.data).ravel()
    breaks = 0
    for area, thres in enumerate(on.param["threshold_list"], start=1):
        cols = torch.as_tensor(np.asarray(faint[:, areamap == area]))
        test = torch.mean(cols * cols, dim=0)
        breaks += int((test > thres).any())
    assert total["greedy.iterations"] == power + breaks
    areas = [s for s in spans if s.name == "greedy.area"]
    assert total["greedy.area_columns"] == sum(
        s.attrs["columns"] for s in areas
        for c in counts if c.name == "greedy.iterations"
        and s.start_ns <= c.t_ns <= s.end_ns)
    assert 0 < total["greedy.nuisance_columns"] < total["greedy.area_columns"]


def test_greedy_power_columns_are_the_gathered_blocks(sessions):
    """Σ ``greedy.power_columns`` is the columns the power iterations read:
    each one's block, npyp wide, which is mapO2's sum less the nuisance
    columns of the iterations that ran none (an area's last, at a
    break), and below the area's columns that the iterations count."""
    on = sessions["on"]
    _, counts = sessions["records"]
    power = [c.n for c in counts if c.name == "greedy.power_columns"]
    assert power == sessions["power_columns"]
    assert len(power) == sessions["power_iterations"] > 0
    faint = sessions["faint"]
    faint = faint.reshape(faint.shape[0], -1)
    areamap = np.asarray(on.areamap.data).ravel()
    left = 0
    for area, thres in enumerate(on.param["threshold_list"], start=1):
        cols = torch.as_tensor(np.asarray(faint[:, areamap == area]))
        left += int((torch.mean(cols * cols, dim=0) > thres).sum())
    assert sum(power) == int(np.asarray(on.mapO2.data).sum()) - left
    area_columns = sum(c.n for c in counts if c.name == "greedy.area_columns")
    assert 0 < sum(power) < area_columns


@pytest.mark.parametrize("traced", [False, True], ids=["off", "on"])
def test_greedy_pca_counts_its_power_columns_while_tracing(traced,
                                                          monkeypatch):
    """One area: each power iteration gets that iteration's npyp columns,
    and counts them as ``greedy.power_columns`` while a profile records;
    with tracing off nothing is recorded."""
    rng = np.random.default_rng(5)
    z = np.linspace(0.0, 1.0, 60)[:, None]
    cube = rng.normal(size=(60, 200)) + 2.0 * np.cos(3.0 * z)
    cube[:, ::25] += 6.0 * np.cos(7.0 * z + rng.uniform(size=8))
    cube = torch.from_numpy(cube.astype(np.float32))
    test0 = torch.mean(cube * cube, dim=0)
    thres = float(torch.quantile(test0, 0.9))
    widths = []
    real = pca.rank1_left_vector
    monkeypatch.setattr(pca, "rank1_left_vector",
                        lambda m: widths.append(m.shape[1]) or real(m))
    tracing.clear()
    with _cpu_profile() if traced else contextlib.nullcontext():
        _, mapo2, _ = pca.greedy_pca(cube, torch.ones(200, dtype=torch.bool),
                                     test0, thres)
    spans, counts = tracing.records()
    tracing.clear()
    assert len(widths) >= 2
    if not traced:
        assert (spans, counts) == ([], [])
        return
    power = [c.n for c in counts if c.name == "greedy.power_columns"]
    nuisance = [c.n for c in counts if c.name == "greedy.nuisance_columns"]
    assert power == widths == nuisance[:len(power)]
    assert sum(nuisance) == int(mapo2.sum())
    assert sum(power) < sum(c.n for c in counts
                            if c.name == "greedy.area_columns")


def test_lines_chunks_are_the_cat1_lines_over_64(sessions):
    spans, counts = sessions["records"]
    n = len(sessions["on"].Cat1)
    chunks = [s for s in spans if s.name == "lines.chunk"]
    assert len(chunks) == math.ceil(n / 64) > 0
    assert sum(s.attrs["lines"] for s in chunks) == n
    assert sum(c.n for c in counts if c.name == "lines.lines") == n


def test_timestat_totals_equal_the_step_spans(sessions):
    on = sessions["on"]
    steps = {s.name: (s.end_ns - s.start_ns) / 1e9
             for s in sessions["records"].spans if s.name in STEPS}
    for step in on.steps.values():
        if step.idx <= 10:
            assert step.meta["runtime"] == steps[f"step{step.idx:02d}"]
    table = on.timestat(table=True)
    total = list(table["Exec Time"])[-1]
    assert total == str(datetime.timedelta(
        seconds=sum(on.steps[n].meta["runtime"] for n in on.steps
                    if "execution_date" in on.steps[n].meta)))
    assert total == str(datetime.timedelta(seconds=sum(steps.values())))


def test_greedy_pca_counts_a_capped_area():
    """``itermax=0``: the one greedy iteration is counted, with every
    column above the threshold as nuisance, and runs no power
    iteration."""
    rng = np.random.default_rng(3)
    cube = torch.from_numpy(rng.normal(size=(40, 30)).astype(np.float32))
    valid = torch.ones(30, dtype=torch.bool)
    test0 = torch.mean(cube * cube, dim=0)
    thres = float(torch.quantile(test0, 0.5))
    tracing.clear()
    with _cpu_profile():
        _, mapo2, nstop = pca.greedy_pca(cube, valid, test0, thres,
                                         itermax=0)
    spans, counts = tracing.records()
    tracing.clear()
    assert nstop == 1 and not spans
    got = {c.name: c.n for c in counts}
    assert got == {"greedy.iterations": 1,
                   "greedy.nuisance_columns": int((test0 > thres).sum()),
                   "greedy.area_columns": 30}
    assert int(mapo2.sum()) == got["greedy.nuisance_columns"]


# -- step 05's fields -----------------------------------------------------
def _step05(tmp_path, nfields, monkeypatch):
    """A small mosaic of ``nfields`` through step 05; returns its records
    and the calls that waited for a device (``tracing._sync_stream``,
    ``torch.cuda.synchronize``, ``torch.cuda.current_stream``)."""
    import mosaic_cases

    waits = []
    real = tracing._sync_stream
    monkeypatch.setattr(tracing, "_sync_stream",
                        lambda d: waits.append(("stream", d)) or real(d))
    for name in ("synchronize", "current_stream"):
        monkeypatch.setattr(torch.cuda, name,
                            lambda *a, _n=name, **k: waits.append((_n, a)))
    tracing.clear()
    orig, _, _ = mosaic_cases.session(tmp_path, nfields, 3230000123,
                                      steps=5)
    orig.close_logfile()
    got = tracing.records()
    tracing.clear()
    return orig, got, waits


@pytest.mark.parametrize("nfields", [1, 4])
def test_step05_records_a_span_per_field_and_the_bank(tmp_path, monkeypatch,
                                                      nfields):
    from origin_tpu_torch.ops.convolve import fft2_shape

    with _cpu_profile():
        orig, (spans, counts), waits = _step05(tmp_path, nfields,
                                               monkeypatch)
    fields = [s for s in spans if s.name == "glr.field"]
    (step05,) = [s for s in spans if s.name == "step05"]
    assert [s.attrs["index"] for s in fields] == list(range(nfields))
    for s in fields:
        assert s.parent == "step05" and s.field == step05.field
        assert step05.start_ns <= s.start_ns <= s.end_ns <= step05.end_ns
    total = collections.Counter()
    for c in counts:
        total[c.name] += c.n
    assert sum(c.name == "glr.fields" for c in counts) == 1
    assert total["glr.fields"] == nfields
    nz, ny, nx = orig.shape
    fy, fx = fft2_shape((ny, nx), (25, 25))
    assert total["glr.bank_bytes"] == nfields * nz * fy * (fx // 2 + 1) * 8
    # each span waits for the device at both ends (the CPU: no stream)
    assert waits == [("stream", torch.device("cpu"))] * (2 * nfields)


def test_off_step05_records_nothing_and_waits_for_no_device(tmp_path,
                                                            monkeypatch):
    assert not tracing.enabled()
    _, got, waits = _step05(tmp_path, 4, monkeypatch)
    assert got == ([], []) and waits == []


# -- on the card --------------------------------------------------------
@pytest.mark.gpu
def test_cuda_a_span_brackets_its_sweep_kernel_on_the_trace_clock():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from torch.autograd import DeviceType

    from origin_tpu_torch.core.profiles import (
        DICO_3FWHM, default_dictionary_path, load_dictionary,
    )
    from origin_tpu_torch.ops import glr
    from origin_tpu_torch.ops.sweep import spectral_sweep

    dev = torch.device("cuda")
    nz, ny, nx = 700, 40, 50
    profiles, _ = load_dictionary(default_dictionary_path(DICO_3FWHM))
    t_num, t_den, pad_left, _ = glr.pack_profiles_toeplitz(
        glr.prepare_profiles(profiles), block=128)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(nz, ny, nx)).astype(
        np.float32)).to(dev)
    n = torch.from_numpy(rng.uniform(0.5, 2.0, size=(nz, ny, nx)).astype(
        np.float32)).to(dev)
    args = (x, n, torch.from_numpy(t_num).to(dev),
            torch.from_numpy(t_den).to(dev), pad_left, nz)
    spectral_sweep(*args)  # built and warm
    torch.cuda.synchronize()
    tracing.clear()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        assert tracing.enabled()
        with tracing.step_span("step05", dev, field=tracing.new_field()):
            spectral_sweep(*args)
    (rec,), _ = tracing.records()
    tracing.clear()
    kernels = [(e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA
               and "sweep_kernel" in e.name()]
    assert len(kernels) == 1
    (k0, k1), = kernels
    assert rec.start_ns <= k0 < k1 <= rec.end_ns
    # the same clock: the span holds little besides the launch and sync
    assert rec.end_ns - rec.start_ns < 50 * (k1 - k0) + 5e6
    assert rec.attrs["peak_end"] >= rec.attrs["peak_start"] > 0
