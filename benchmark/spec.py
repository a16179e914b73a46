"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix.
The configuration's file is its ``file`` in ``configs``; the mix is
``traffic/<traffic>.json``; each per-layer metric is
``metrics/<name>.json`` and names its reader, ``readers/<reader>.py``.
A later cell, mix, configuration or metric is added by adding files and
entries: nothing here names one.
"""

import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root):
    """The parsed ``BENCHMARK.json`` at the checkout ``root``."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _read(path):
    with open(path) as fh:
        return json.load(fh)


def resolve(bench, workload, root, here=HERE):
    """``(cell, config, traffic, end_to_end, per_layer)`` of a cell: its
    entry, the parsed configuration and traffic files, and the metric
    entries that the cell reports (per-layer ones with their files)."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf_entry = next(c for c in bench["configs"]
                      if c["name"] == cell["config"])
    config = _read(os.path.join(root, conf_entry["file"]))
    traffic = _read(os.path.join(here, "traffic", cell["traffic"] + ".json"))

    def reports(metric):
        return workload in metric.get("workloads", [workload])

    e2e = [m for m in bench["end_to_end"] if reports(m)]
    per_layer = []
    for m in bench["per_layer"]:
        if reports(m):
            spec = _read(os.path.join(here, "metrics", m["name"] + ".json"))
            per_layer.append(dict(spec, **m))
    return cell, config, traffic, e2e, per_layer


def names(bench):
    """Every name, unit and reduced key of ``bench`` that the contract
    restricts, as ``(kind, text)`` pairs."""
    out = []
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in bench[key]:
            out.append(("name", entry["name"]))
            if "unit" in entry:
                out.append(("unit", entry["unit"]))
    for cell in bench["workloads"]:
        out += [("name", cell["config"]), ("name", cell["traffic"])]
    for conf in bench["configs"]:
        out += [("name", k) for k in conf["reduced"]]
    return out


def bad_names(bench):
    """The names and units of ``bench`` outside the allowed characters."""
    return [(kind, text) for kind, text in names(bench)
            if not (NAME if kind == "name" else UNIT).match(text)]
