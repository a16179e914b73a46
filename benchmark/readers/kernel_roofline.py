"""A kernel's share of its roofline over the traced window.

The least time of one launch is the larger of its operations over the
peak rate of their type and its bytes over the HBM rate; the operations
and bytes come from ``work/<work>.py`` (shapes of the configuration).
The share is that least time, times the launches, over the kernel's
device time by name in the trace.
"""

import importlib

from .. import peaks


def read(ctx, spec):
    trace = ctx["trace"]
    if trace is None:
        return None
    seconds, launches = trace.kernel(spec["kernel"])
    if launches == 0 or seconds <= 0:
        return None
    work = importlib.import_module(f"{__package__.rsplit('.', 1)[0]}.work."
                                   f"{spec['work']}")
    flops, nbytes, peak_key = work.count(ctx["config"], ctx["profiles"])
    least = max(flops / peaks.PEAKS[peak_key], nbytes / peaks.PEAKS["hbm_bytes"])
    return 100.0 * least * launches / seconds
