"""Seconds per field in the host spans that the metric's file lists;
nothing where the run recorded none of them."""


def read(ctx, spec):
    spans = ctx["spans"]
    if spans is None or not ctx["fields"]:
        return None
    if not any(n in spec["spans"] for n, _, _ in spans.records):
        return None
    total = sum(spans.seconds(name) for name in spec["spans"])
    return total / ctx["fields"]
