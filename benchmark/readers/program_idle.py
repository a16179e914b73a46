"""Device-idle seconds per field during which no span of the program is
open: the idle gaps of the device trace (the window less the union of
its kernel, copy and set intervals), each instant named by the innermost
program span open then (``program_span`` says which records count).
None without a device trace or without a program span in the window."""

from . import program_span


def idle_by_span(trace, spans):
    """``{name: idle ns}`` over ``trace``'s window, each idle instant
    given to the innermost of ``spans`` (program span records) open then,
    ``"none"`` where none is."""
    events = []
    for i, s in enumerate(spans):
        events += [(s.start_ns, 1, i), (s.end_ns, 0, i)]
    edges = [trace.t0] + [x for ab in trace.busy for x in ab] + [trace.t1]
    for k in range(0, len(edges) - 1, 2):
        if edges[k + 1] > edges[k]:
            events += [(edges[k], 3, -1), (edges[k + 1], 2, -1)]
    events.sort()
    out, open_, idle, last = {}, [], False, None
    for t, kind, i in events:
        if idle and last is not None and t > last:
            name = spans[open_[-1]].name if open_ else "none"
            out[name] = out.get(name, 0) + (t - last)
        last = t
        if kind == 1:
            open_.append(i)
        elif kind == 0:
            open_.remove(i)
        else:
            idle = kind == 3
    return out


def read(ctx, spec):
    trace = ctx.get("trace")
    got = program_span.in_window(ctx)
    if trace is None or got is None or not got[0]:
        return None
    return idle_by_span(trace, got[0]).get("none", 0) / 1e9 / ctx["fields"]
