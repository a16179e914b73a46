"""A stage's share of its roofline over the program's own spans of it.

The least time of the stage, once a field, is the larger of its
operations over the peak rate of their type and its bytes over the HBM
rate (``work/<work>.py``, from the configuration's shapes; ``peaks.py``).
The share is that least time over the seconds a field of the
device-timed program spans that the metric's file lists
(``device_span``), and None where those read nothing.
"""

import importlib

from .. import peaks
from . import device_span


def read(ctx, spec):
    seconds = device_span.read(ctx, spec)
    if not seconds:
        return None
    work = importlib.import_module(f"{__package__.rsplit('.', 1)[0]}.work."
                                   f"{spec['work']}")
    flops, nbytes, peak_key = work.count(ctx["config"], ctx["profiles"])
    least = max(flops / peaks.PEAKS[peak_key], nbytes / peaks.PEAKS["hbm_bytes"])
    return 100.0 * least / seconds
