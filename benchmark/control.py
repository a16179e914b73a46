"""Readings that set the limits of ``correct``: the program and the control.

    python3 benchmark/control.py --workload <cell> --seeds <n,n,...>

For each seed: the cell's field is made and written, one field runs
through the survey's steps (as a run's window does), and its products
are held to the float64 reference, as a run holds them.  The control is
the reference put in the program's place one precision lower: float32
with TF32 matrix products, fed the same inputs stage by stage.  Both sets
of numbers go through the limits as a run's do (``check.verdict``): the
program's must come out correct, the control's not.  One JSON line per
seed goes to standard output.  The benchmark's runs do not run this.
"""

import argparse
import gc
import json
import os
import shutil
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None, device="cuda", root=ROOT):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, root)
    import torch

    from benchmark import check, run, spec
    from benchmark.trace import Spans

    bench = spec.load(root)
    cell, config, traffic, _, _ = spec.resolve(
        bench, args.workload, root, os.path.join(root, "benchmark"))
    for key, val in config.get("environment", {}).items():
        os.environ[key] = str(val)
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    workdir = os.path.join(root, "build", "benchmark", "control")
    lines = []
    for seed in [int(s) for s in args.seeds.split(",")]:
        shutil.rmtree(workdir, ignore_errors=True)
        os.makedirs(workdir)
        t0 = time.perf_counter()
        survey = run.Survey(config, workdir, Spans(False, sync), device,
                            root)
        survey.write(traffic, seed)
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        orig = survey.field()
        sync()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        prog = check.products(orig)
        survey.release(orig)
        del orig
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        program, ctl = check.readings(
            prog, run.reference_inputs(config, traffic, seed, device, root),
            device, control=True)
        t2 = time.perf_counter()
        limits = config["limits"]
        row = dict(workload=cell["name"], seed=seed, program=program,
                   control=ctl, peak_gib=peak / 2 ** 30,
                   field_and_setup_s=t1 - t0, check_s=t2 - t1,
                   cat1_lines=len(prog["cat1"]),
                   cat3_sources=len(prog["cat3_sources"]),
                   program_correct=check.verdict(program, limits)[1],
                   control_correct=check.verdict(ctl, limits)[1])
        del prog
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        print(json.dumps(row), flush=True)
        lines.append(row)
    shutil.rmtree(workdir, ignore_errors=True)
    return lines


if __name__ == "__main__":
    main()
