"""CPU tests of the readers of the program's own spans and counters
(``readers/program_span.py``, ``program_count.py``, ``program_idle.py``).

Each reader on synthetic records: the window (the device trace's, else
the extent of the benchmark's spans) keeps only what falls inside it, the
division by the fields, and the cases with nothing to read (no window, no
record there, a program without its tracer).  Then the tiny cell of
``test_bench_harness.py`` run inside a CPU ``torch.profiler`` profile
reports the nine metrics of the program's spans and counters beside the
benchmark's own; ``idle_unnamed_s`` needs a device trace.

    python -m pytest -q benchmark/tests
"""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from benchmark import spec  # noqa: E402
from benchmark.readers import (  # noqa: E402
    program_count, program_idle, program_span,
)
from benchmark.trace import Spans, Trace  # noqa: E402
from origin_tpu_torch import tracing  # noqa: E402
from origin_tpu_torch.tracing import CountRecord, SpanRecord  # noqa: E402

NINE = {"ingest_decode_s", "ingest_derive_s", "preprocess_wait_s",
        "greedy_iterations", "greedy_useful_share", "greedy_iter_s",
        "lines_chunks_s", "purity_counts_s", "masks_write_s"}
S = 10 ** 9  # ns a second


def _span(name, a, b, parent=None):
    return SpanRecord(name, a, b, parent, 1, {})


SPANS = [
    _span("init", 0, 100),           # before the window
    _span("init", 1000, 3000),
    _span("ingest.decode", 1100, 1900, "init"),
    _span("step04", 3000, 9000),
    _span("greedy.area", 3100, 8900, "step04"),
    _span("greedy.iteration", 3200, 4200, "greedy.area"),
    _span("greedy.iteration", 4300, 6300, "greedy.area"),
    _span("ingest.decode", 9500, 12000),  # across the window's end
]
COUNTS = [
    CountRecord("greedy.iterations", 50, 7, 1),  # before the window
    CountRecord("greedy.iterations", 3150, 1, 1),
    CountRecord("greedy.nuisance_columns", 3150, 30, 1),
    CountRecord("greedy.area_columns", 3150, 200, 1),
    CountRecord("greedy.iterations", 4250, 1, 1),
    CountRecord("greedy.nuisance_columns", 4250, 10, 1),
    CountRecord("greedy.area_columns", 4250, 200, 1),
    CountRecord("greedy.iterations", 10500, 1, 1),  # after it
]


@pytest.fixture
def program(monkeypatch):
    monkeypatch.setattr(tracing, "records",
                        lambda: tracing.Records(list(SPANS), list(COUNTS)))


def _ctx(trace=None, spans=None, fields=2):
    return dict(trace=trace, spans=spans, fields=fields)


def _trace(busy=((1500, 2500), (4000, 8000))):
    return Trace([(a, b, "k") for a, b in busy], 1000, 10000)


def _bench_spans(*records):
    s = Spans(True, lambda: None)
    s.records = list(records)
    return s


# -- program_span --------------------------------------------------------
def test_span_sums_inside_the_trace_window_per_field(program):
    ctx = _ctx(_trace())
    got = program_span.read(ctx, dict(spans=["greedy.iteration"]))
    assert got == (1000 + 2000) / S / 2
    # the decode before t0 and the one across t1 are left out
    assert program_span.read(ctx, dict(spans=["ingest.decode"])) \
        == 800 / S / 2
    assert program_span.read(ctx, dict(spans=["init", "step04"])) \
        == (2000 + 6000) / S / 2


def test_span_window_without_a_trace_is_the_benchmark_spans(program):
    ctx = _ctx(None, _bench_spans(("init", 1000, 3000),
                                  ("step04", 3000, 13000)))
    assert program_span.read(ctx, dict(spans=["ingest.decode"])) \
        == (800 + 2500) / S / 2
    ctx = _ctx(None, _bench_spans(("init", 50, 3000)))
    assert program_span.read(ctx, dict(spans=["init"])) == 2000 / S / 2


def test_span_reads_nothing_where_there_is_nothing(program, monkeypatch):
    spec_ = dict(spans=["greedy.iteration"])
    assert program_span.read(_ctx(), spec_) is None  # a --trace 0 run
    assert program_span.read(_ctx(None, _bench_spans()), spec_) is None
    assert program_span.read(_ctx(_trace()), dict(spans=["lines.chunk"])) \
        is None
    late = Trace([], 20000, 30000)
    assert program_span.read(_ctx(late), spec_) is None
    monkeypatch.setitem(sys.modules, "origin_tpu_torch.tracing", None)
    assert program_span.program_records() is None
    assert program_span.read(_ctx(_trace()), spec_) is None


# -- program_count -------------------------------------------------------
def test_count_sums_per_field_and_the_ratio(program):
    ctx = _ctx(_trace())
    assert program_count.read(ctx, dict(counters=["greedy.iterations"])) \
        == 2 / 2
    share = program_count.read(ctx, dict(ratio=["greedy.nuisance_columns",
                                                "greedy.area_columns"]))
    assert share == 100.0 * 40 / 400
    assert program_count.read(ctx, dict(counters=["lines.lines"])) is None
    assert program_count.read(ctx, dict(ratio=["lines.lines",
                                               "lines.chunks"])) is None
    assert program_count.read(_ctx(), dict(counters=["greedy.iterations"])) \
        is None


# -- program_idle --------------------------------------------------------
def test_idle_names_each_instant_by_the_innermost_open_span(program):
    trace = _trace()
    spans, _ = program_span.in_window(_ctx(trace))
    by = program_idle.idle_by_span(trace, spans)
    # idle: [1000, 1500), [2500, 4000), [8000, 10000)
    assert by == {"ingest.decode": 400, "init": 100 + 500,
                  "step04": 100 + 100, "greedy.area": 100 + 900,
                  "greedy.iteration": 800, "none": 1000}
    assert sum(by.values()) == round(trace.window_s * S - trace.busy_s * S)
    assert program_idle.read(_ctx(trace), {}) == 1000 / S / 2


def test_idle_reads_nothing_without_a_trace_or_spans(program, monkeypatch):
    assert program_idle.read(_ctx(None, _bench_spans(("x", 0, 99999))),
                             {}) is None
    assert program_idle.read(_ctx(Trace([], 20000, 30000)), {}) is None
    monkeypatch.setattr(tracing, "records",
                        lambda: tracing.Records([], list(COUNTS)))
    assert program_idle.read(_ctx(_trace()), {}) is None


# -- the harness, on the CPU ---------------------------------------------
def test_a_run_inside_a_cpu_profile_reports_the_program_metrics(tmp_path):
    from test_bench_harness import _run, _tiny_root
    from torch.profiler import ProfilerActivity, profile

    root = _tiny_root(tmp_path)
    with profile(activities=[ProfilerActivity.CPU]):
        rc, line = _run(root, trace=1)
    assert rc == 0 and line["correct"] is True
    bench = spec.load(ROOT)
    readers = {m["name"]: json.load(open(os.path.join(
        ROOT, "benchmark", "metrics", m["name"] + ".json")))["reader"]
        for m in bench["per_layer"]}
    assert NINE == {n for n, r in readers.items()
                    if r in ("program_span", "program_count")}
    spans = {n for n, r in readers.items() if r == "span"}
    assert set(line["metrics"]) == spans | NINE
    got = {n: line["metrics"][n]["value"] for n in NINE}
    assert got["greedy_iterations"] >= 1
    assert 0 < got["greedy_useful_share"] <= 100
    for name in NINE - {"greedy_iterations", "greedy_useful_share"}:
        assert got[name] > 0, name
    # the program's spans lie inside the benchmark's: its step 04 holds
    # the greedy iterations, its init the decode
    assert got["greedy_iter_s"] < line["metrics"]["greedy_pca_s"]["value"]
    assert got["ingest_decode_s"] + got["ingest_derive_s"] \
        < line["metrics"]["ingest_s"]["value"]
