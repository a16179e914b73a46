"""Seconds per field in the program's spans that the metric's file lists
(``program_span``), for spans that wait for the device at both ends while
tracing is on (``origin_tpu_torch.tracing.span(..., sync=device)``), so
that each one times the device's pass through the work enqueued inside
it.  None without a device trace, as in a run on the CPU, where there is
no device pass to time; else as ``program_span``: None where no such span
falls in the trace's window (tracing was off, or the program has no such
span).
"""

from . import program_span


def read(ctx, spec):
    if ctx.get("trace") is None:
        return None
    return program_span.read(ctx, spec)
