"""Spans around the survey's calls, and the reduction of a device trace.

Host spans are ``(name, start_ns, end_ns)`` on the wall clock
(``time.time_ns``), the clock that ``torch.profiler``'s events carry, so
each idle gap of the device can be named by the span open on the host.
A span ends in ``torch.cuda.synchronize()`` when tracing is on, so that
its time holds its device work.
"""

import contextlib
import re
import time


class Spans:
    """Records spans when ``enabled``; otherwise each span is free."""

    def __init__(self, enabled, sync):
        self.enabled = enabled
        self.sync = sync
        self.records = []

    @contextlib.contextmanager
    def span(self, name):
        if not self.enabled:
            yield
            return
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.sync()
            self.records.append((name, t0, time.time_ns()))

    def seconds(self, name):
        return sum(b - a for n, a, b in self.records if n == name) / 1e9

    def open_at(self, t_ns):
        """Name of the innermost span open at ``t_ns`` ("none" if none)."""
        best = None
        for name, a, b in self.records:
            if a <= t_ns < b and (best is None or a >= best[1]):
                best = (name, a)
        return best[0] if best else "none"


def device_intervals(prof):
    """``[(start_ns, end_ns, name)]`` of every device activity (kernels,
    copies, sets) in a ``torch.profiler.profile`` that ran."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            start = e.start_ns()
            out.append((start, start + e.duration_ns(), e.name()))
    return out


def union(intervals):
    """Merged, sorted ``[(start, end)]`` of ``intervals``."""
    merged = []
    for a, b in sorted((a, b) for a, b, *_ in intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1][1] = b
        else:
            merged.append([a, b])
    return merged


class Trace:
    """A traced window reduced in memory: its device intervals clipped to
    ``[t0, t1]`` (ns), busy time and idle gaps."""

    def __init__(self, intervals, t0, t1):
        self.t0, self.t1 = t0, t1
        self.ops = [(max(a, t0), min(b, t1), n) for a, b, n in intervals
                    if b > t0 and a < t1]
        self.busy = union(self.ops)

    @property
    def window_s(self):
        return (self.t1 - self.t0) / 1e9

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.busy) / 1e9

    def kernel(self, pattern):
        """``(seconds, launches)`` of the device operations whose name
        matches ``pattern`` (a regular expression)."""
        rx = re.compile(pattern)
        hits = [b - a for a, b, n in self.ops if rx.search(n)]
        return sum(hits) / 1e9, len(hits)

    def top_ops(self, n=10):
        by = {}
        for a, b, name in self.ops:
            by[name] = by.get(name, 0) + (b - a)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], ns / 1e9] for name, ns in top]

    def gaps(self, spans, n=10):
        """The ``n`` longest idle gaps of the device in the window, each
        named by the host span open where it starts."""
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        gaps = [(edges[i + 1] - edges[i], edges[i])
                for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(reverse=True)
        return [[spans.open_at(start), ns / 1e9] for ns, start in gaps[:n]]
