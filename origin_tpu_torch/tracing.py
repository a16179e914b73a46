"""The port's spans and counters, on the clock of the device trace.

Tracing is on exactly while a ``torch.profiler`` profile records in the
calling thread (:func:`enabled`); nothing else turns it on.  While it is
on:

- :func:`span` records ``(name, start_ns, end_ns, parent, field, attrs)``
  and opens a ``torch.profiler.record_function`` range of the same name,
  so a Chrome trace of the profile shows the spans over their kernels;
- :func:`count` records ``(name, t_ns, n, field)``;
- a session's init and step spans (:func:`step_span`) synchronize their
  device at their end, and record ``torch.cuda.max_memory_allocated()`` at
  their start and end (``peak_start``, ``peak_end``; the peak is never
  reset here);
- a span given ``sync=device`` synchronizes that device's current stream
  at both ends (on a CUDA device; nothing on the CPU), so that it times
  the device's work enqueued inside it: step 05's ``glr.field``.

Times are ``time.time_ns()``, the wall clock that kineto's device events
carry, so the spans and the device activity share one timeline.
``parent`` is the name of the enclosing span of the same thread, and
``field`` the id a session takes at its init (:func:`new_field`); a span
without its own takes its parent's.  Every other span is placed where the
code already waits on the device, or around host work, and adds no
synchronization.  The records stay in memory until :func:`clear`; a reader
takes them with :func:`records`.

While tracing is off, :func:`span` costs one probe and returns a shared
no-op context, :func:`count` one probe, and :func:`step_span` measures
host time only (``Step.__call__`` keeps it as ``meta["runtime"]``): nothing
is recorded, synchronized or read from the device.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import namedtuple

import torch
from torch.autograd.profiler import record_function

__all__ = [
    "SpanRecord",
    "CountRecord",
    "Records",
    "enabled",
    "span",
    "step_span",
    "count",
    "new_field",
    "records",
    "clear",
]

SpanRecord = namedtuple("SpanRecord",
                        "name start_ns end_ns parent field attrs")
CountRecord = namedtuple("CountRecord", "name t_ns n field")
Records = namedtuple("Records", "spans counts")

#: True while a torch.profiler profile records in the calling thread
enabled = torch._C._autograd._profiler_enabled

_OFF = contextlib.nullcontext()
_spans = []
_counts = []
_local = threading.local()
_fields = itertools.count(1)


def _stack():
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def new_field():
    """A fresh field id for a session (taken at its init)."""
    return next(_fields)


class _Span:
    """An open span; ``elapsed_s`` reads its host time so far (or whole,
    once closed).  ``device`` is the CUDA device that a step span
    synchronizes, else None; ``stream`` the device whose current stream
    the span synchronizes at both ends, else None."""

    __slots__ = ("name", "field", "attrs", "device", "on", "stream",
                 "start_ns", "end_ns", "parent", "_range")

    def __init__(self, name, field, device, attrs, on, stream=None):
        self.name, self.field, self.attrs = name, field, attrs
        self.device, self.on, self.stream = device, on, stream
        self.end_ns = None

    def __enter__(self):
        if self.on:
            stack = _stack()
            outer = stack[-1] if stack else None
            self.parent = outer.name if outer is not None else None
            if self.field is None and outer is not None:
                self.field = outer.field
            if self.device is not None:
                self.attrs["peak_start"] = torch.cuda.max_memory_allocated(
                    self.device)
            stack.append(self)
            self._range = record_function(self.name)
            self._range.__enter__()
            if self.stream is not None:
                _sync_stream(self.stream)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        if self.on and exc_type is None:
            if self.device is not None:
                torch.cuda.synchronize(self.device)
            elif self.stream is not None:
                _sync_stream(self.stream)
        self.end_ns = time.time_ns()
        if self.on:
            self._range.__exit__(exc_type, exc, tb)
            _stack().pop()
            if self.device is not None:
                self.attrs["peak_end"] = torch.cuda.max_memory_allocated(
                    self.device)
            _spans.append(SpanRecord(self.name, self.start_ns, self.end_ns,
                                     self.parent, self.field, self.attrs))
        return False

    @property
    def elapsed_s(self):
        end = self.end_ns if self.end_ns is not None else time.time_ns()
        return (end - self.start_ns) / 1e9


def _sync_stream(device):
    """Waits for the work enqueued on ``device``'s current stream (a CUDA
    device; nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def span(name, *, field=None, sync=None, **attrs):
    """A span around host work or up to an existing wait on the device;
    with ``sync`` (a device), around the device work enqueued inside it,
    its current stream synchronized at both ends.  The shared no-op
    context while tracing is off: no synchronization then."""
    if not enabled():
        return _OFF
    return _Span(name, field, None, attrs, True,
                 None if sync is None else torch.device(sync))


def step_span(name, device, *, field=None, **attrs):
    """The span of a session's init or of one of its steps: always timed
    on the host (``elapsed_s``); while tracing is on, also recorded, with
    ``device`` synchronized at its end and its running memory peak read at
    both ends."""
    on = enabled()
    device = torch.device(device) if on and device is not None else None
    cuda = device if device is not None and device.type == "cuda" else None
    return _Span(name, field, cuda, attrs, on)


def count(name, n=1):
    """Adds ``n`` to counter ``name`` while tracing is on."""
    if enabled():
        stack = _stack()
        _counts.append(CountRecord(name, time.time_ns(), n,
                                   stack[-1].field if stack else None))


def records():
    """``(spans, counts)``: copies of every record kept so far."""
    return Records(list(_spans), list(_counts))


def clear():
    """Drops every record kept so far."""
    del _spans[:], _counts[:]
