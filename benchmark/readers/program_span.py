"""Seconds per field in the program's own spans that the metric's file
lists (``origin_tpu_torch.tracing``), over the traced window.

The program records its spans and counters only while a
``torch.profiler`` profile records, that is in a ``--trace 1`` run; it
keeps them in memory and hands them over through ``tracing.records()``.
A reader keeps the records that fall inside the window: ``[t0, t1]`` of
the device trace, or, without one, the extent of the benchmark's own
spans.  Nothing is read (None) where no record falls there: tracing was
off, or the program has no tracer.
"""

import importlib


def program_records():
    """The program's ``(spans, counts)``, or None where it has no
    tracer."""
    try:
        tracing = importlib.import_module("origin_tpu_torch.tracing")
    except ImportError:
        return None
    return tracing.records()


def window(ctx):
    """``(t0, t1)`` in ns on the wall clock, or None."""
    trace = ctx.get("trace")
    if trace is not None:
        return trace.t0, trace.t1
    spans = ctx.get("spans")
    if spans is None or not spans.records:
        return None
    return (min(a for _, a, _ in spans.records),
            max(b for _, _, b in spans.records))


def in_window(ctx):
    """``(spans, counts)`` of the program inside the window, or None."""
    got, win = program_records(), window(ctx)
    if got is None or win is None or not ctx["fields"]:
        return None
    t0, t1 = win
    return ([s for s in got.spans if t0 <= s.start_ns and s.end_ns <= t1],
            [c for c in got.counts if t0 <= c.t_ns <= t1])


def read(ctx, spec):
    got = in_window(ctx)
    if got is None:
        return None
    hits = [s.end_ns - s.start_ns for s in got[0] if s.name in spec["spans"]]
    if not hits:
        return None
    return sum(hits) / 1e9 / ctx["fields"]
