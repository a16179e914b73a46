"""The program's counters over the traced window (``program_span`` says
which records count): the sum of the listed counters per field, or, for
a metric whose file gives ``ratio`` ``[a, b]``, ``100 * sum(a) /
sum(b)``.  None where no record of them falls in the window."""

from . import program_span


def read(ctx, spec):
    got = program_span.in_window(ctx)
    if got is None:
        return None
    counts = got[1]

    def total(name):
        return sum(c.n for c in counts if c.name == name)

    if "ratio" in spec:
        num, den = spec["ratio"]
        below = total(den)
        return 100.0 * total(num) / below if below > 0 else None
    if not any(c.name in spec["counters"] for c in counts):
        return None
    return sum(total(name) for name in spec["counters"]) / ctx["fields"]
