"""Share of the traced window in which no operation ran on the device:
``100 * (1 - busy / wall)``, busy the union of kernel, copy and set
intervals."""


def read(ctx, spec):
    trace = ctx["trace"]
    if trace is None or trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
