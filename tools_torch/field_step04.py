#!/usr/bin/env python3
"""Step 04 of origin_tpu_torch on a synthetic field against its references.

Runs steps 01-07 of the port on the synthetic field of tools/bench_e2e.py
(seed 7, default parameters, purity 0.8).  Then, for each reference, it
runs the port's steps 01-03, swaps in that reference's cube_faint
(``TorchEngine.load_state``) and runs the port's steps 05-07, so that the
catalogs differ only by step 04.  The references:

- ``oracle``: the float64 transcription of the published greedy PCA in
  tests/oracle.py (scipy ARPACK ``svds``), area by area on the host;
- ``jax`` and ``jax_full_budget``: steps 01-04 of the JAX package on the
  host CPU, as it is and with its power iteration run to its whole budget
  (tests/jax_full_budget.py), as the port runs it.

Prints, for the port and each reference, the thresholds, Cat0/Cat1 counts
and greedy iterations, and how many spaxels' mapO2 differ from the port's.
Writes chiprun_out/field_step04_<refs>.json.

Usage: python3 tools_torch/field_step04.py [--refs oracle,jax,jax_full_budget]
       [--device cuda] [--ny 100 --nx 200]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(orig, names, **kw06):
    for name in names:
        method = getattr(orig, next(m for m in dir(orig)
                                    if m.startswith(name + "_")))
        method(**(kw06 if name == "step06" else {}))


def _catalog(orig, mapo2, port_mapo2, seconds):
    return dict(threshold=float(orig.param["threshold"]),
                threshold_std=float(orig.param["threshold_std"]),
                cat0=len(orig.Cat0), cat1=len(orig.Cat1),
                sources=len(set(int(i) for i in orig.Cat1["ID"])),
                greedy_iterations=int(mapo2.max()),
                mapO2_differ=int((np.asarray(mapo2) != port_mapo2).sum()),
                step04_s=seconds)


def _oracle_step04(orig):
    from oracle import greedy_pca_oracle

    std = np.asarray(orig.cube_std.data, np.float64)
    areamap = orig.areamap.data
    faint = std.copy()
    mapo2 = np.zeros(areamap.shape, np.int32)
    for area in range(1, int(areamap.max()) + 1):
        sel = areamap == area
        f, m, _ = greedy_pca_oracle(std[:, sel],
                                    np.asarray(orig.testO2[area - 1], float),
                                    float(orig.thresO2[area - 1]), 50.0, 100)
        faint[:, sel], mapo2[sel] = f, m
    return faint.astype(np.float32), mapo2


def _jax_step04(cube_fn, work, full_budget):
    import contextlib

    from jax_full_budget import jax_full_budget
    from origin_tpu import ORIGIN as JaxORIGIN

    name = "jax_full" if full_budget else "jax"
    with jax_full_budget() if full_budget else contextlib.nullcontext():
        orig = JaxORIGIN.init(cube_fn, name=name, path=work,
                              loglevel="WARNING")
        _run(orig, ("step01", "step02", "step03", "step04"))
        faint = np.asarray(orig.cube_faint.data, np.float32)
        mapo2 = np.asarray(orig.mapO2.data)
    orig.close_logfile()
    return faint, mapo2


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--refs", default="oracle",
                    help="comma-separated: oracle, jax, jax_full_budget")
    ap.add_argument("--nz", type=int, default=3681)
    ap.add_argument("--ny", type=int, default=100)
    ap.add_argument("--nx", type=int, default=200)
    args = ap.parse_args()
    refs = args.refs.split(",")
    if {"jax", "jax_full_budget"} & set(refs):
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["ORIGIN_TPU_COMPILE_CACHE"] = "0"
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
    import chip_smoke
    from origin_tpu_torch.pipeline.session import ORIGIN

    bench = chip_smoke._load_file("bench_e2e", os.path.join(REPO, "tools",
                                                            "bench_e2e.py"))
    cube, _ = bench.make_field(args.nz, args.ny, args.nx, seed=7)
    work = os.path.join(REPO, "build", "field_step04")
    os.makedirs(work, exist_ok=True)
    kw = dict(path=work, loglevel="WARNING", device=args.device)

    port = ORIGIN.init(cube, name="port", **kw)
    _run(port, chip_smoke.STEP_NAMES, purity=0.8)
    port_mapo2 = port.mapO2.data
    res = dict(field=[args.nz, args.ny, args.nx], device=args.device,
               port=_catalog(port, port_mapo2, port_mapo2, None))

    cube_fn = os.path.join(work, f"field_{args.refs}.fits")
    if refs != ["oracle"]:
        cube.write(cube_fn)
    for name in refs:
        fed = ORIGIN.init(cube, name=name, **kw)
        _run(fed, ("step01", "step02", "step03"))
        t0 = time.perf_counter()
        if name == "oracle":
            faint, mapo2 = _oracle_step04(fed)
        else:
            faint, mapo2 = _jax_step04(cube_fn, work,
                                       name == "jax_full_budget")
        seconds = time.perf_counter() - t0
        fed.engine.load_state({"cube_faint": faint})
        _run(fed, ("step05", "step06", "step07"), purity=0.8)
        res[name] = _catalog(fed, mapo2, port_mapo2, seconds)
        res[name]["faint_max_abs_diff"] = float(np.abs(
            np.asarray(port.cube_faint.data) - faint).max())
        print(name, json.dumps(res[name]), flush=True)
        fed.close_logfile()
    print(json.dumps(res))
    out = os.path.join(REPO, "chiprun_out", f"field_step04_{args.refs}.json")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as fh:
        json.dump(res, fh, indent=1)


if __name__ == "__main__":
    main()
