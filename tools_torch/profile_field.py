#!/usr/bin/env python3
"""Per-step device profile of origin_tpu_torch's steps 01-11 on one GPU.

Runs the session's init and steps 01-11 on the synthetic 3681x100x200
field (tools_torch/synthetic.py; seed 7, written to a FITS file that the
init reads, as a user's session does; default parameters, purity 0.8,
source files of version "0.1"; chip_smoke.STEP_KWARGS) twice: once cold
under a CUDA-only ``torch.profiler`` profile, once warm under a CPU and
CUDA one.  The times are the program's own spans
(``origin_tpu_torch.tracing``), which record while a profile does: the
init and each step end in a device sync.  For the init and each step of
the warm run it prints the cold and warm walls, the device-busy time (the
union of the device's kernel and memcpy intervals inside the step's span,
``benchmark.trace.union``) and the idle share ``1 - busy / wall``, and the
step's three ops with the most device time; then the device ops with the
most device time overall.  The program's spans also appear on the device
timeline and are left out of both.  Each run's session folder is deleted
after it.  Step 11's host stages of the cold run come from its spans
(wall-clock sums and counts): the device rounds, the two kinds of cutout,
the narrow-band images, the source files' FITS writes, each source's
whole build, and the closing session write.
Writes chiprun_out/profile_field_<mode>.json and the Chrome trace
chiprun_out/profile_field_<mode>_trace.json, <mode> the precision.

Usage: python3 tools_torch/profile_field.py  (with ORIGIN_TPU_PRECISION=bf16x3
in the environment for the bf16x3 mode)
"""

import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: step 11's stages: (span name, its ``cube`` attribute) -> label
STAGES = {
    ("sources.device_rounds", None): "device rounds",
    ("sources.cutouts", "detection"): "detection-cube cutouts",
    ("sources.cutouts", "raw"): "raw-cube cutouts",
    ("sources.images", None): "narrow-band images",
    ("sources.write", None): "source FITS writes",
    ("sources.build", None): "source builds (writes included)",
    ("session.write", None): "session write",
}


def main():
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, REPO)
    import chip_smoke
    from benchmark.trace import device_intervals, union
    from origin_tpu_torch import tracing
    from origin_tpu_torch.pipeline.session import ORIGIN
    from tools_torch.synthetic import make_field

    os.makedirs(chip_smoke.WORK, exist_ok=True)
    cube_fn = os.path.join(chip_smoke.WORK, "profile_field.fits")
    make_field(*chip_smoke.FIELD, seed=7)[0].write(cube_fn)
    names = ("init",) + chip_smoke.STEP_NAMES

    def run(name):
        orig = ORIGIN.init(cube_fn, name=name, path=chip_smoke.WORK,
                           loglevel="WARNING", device="cuda")
        for step in chip_smoke.STEP_NAMES:
            method = getattr(orig, next(m for m in dir(orig)
                                        if m.startswith(step + "_")))
            method(**chip_smoke.STEP_KWARGS.get(step, {}))
        orig.close_logfile()
        shutil.rmtree(orig.outpath, ignore_errors=True)
        return orig.trace_field

    tracing.clear()
    with profile(activities=[ProfilerActivity.CUDA]):
        cold_field = run("profile_cold")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        warm_field = run("profile_warm")
    os.remove(cube_fn)
    spans = tracing.records().spans
    tracing.clear()

    def walls(field):
        return {s.name: s for s in spans
                if s.field == field and s.name in names}

    cold = {n: (s.end_ns - s.start_ns) / 1e9
            for n, s in walls(cold_field).items()}
    warm_spans = walls(warm_field)
    warm = {n: (s.end_ns - s.start_ns) / 1e9 for n, s in warm_spans.items()}
    ranges = {s.name for s in spans}
    device = [iv for iv in device_intervals(prof) if iv[2] not in ranges]
    steps = {}
    for name, s in warm_spans.items():
        a, b = s.start_ns, s.end_ns
        inside = [(max(x, a), min(y, b), op) for x, y, op in device
                  if y > a and x < b]
        busy = sum(y - x for x, y in union(inside)) / 1e9
        by_op = {}
        for x, y, op in inside:
            by_op[op] = by_op.get(op, 0.0) + (y - x) / 1e6
        steps[name] = dict(
            wall_s=warm[name], device_busy_s=busy,
            idle_share=1.0 - busy / warm[name],
            top_ops_ms=sorted(by_op.items(), key=lambda r: -r[1])[:3])
    stages = {label: [0.0, 0] for label in STAGES.values()}
    for s in spans:
        label = STAGES.get((s.name, s.attrs.get("cube")))
        if label is not None and s.field == cold_field:
            stages[label][0] += (s.end_ns - s.start_ns) / 1e9
            stages[label][1] += 1
    ops = sorted(((k.key, k.self_device_time_total, k.count)
                  for k in prof.key_averages()
                  if k.self_device_time_total > 0
                  and k.key not in ranges),
                 key=lambda r: -r[1])[:20]

    card = os.popen("nvidia-smi --query-gpu=name,power.limit "
                    "--format=csv,noheader").read().strip()
    mode = os.environ.get("ORIGIN_TPU_PRECISION") or "highest"
    print(card)
    print(f"ORIGIN_TPU_PRECISION={mode}")
    print("step    cold_s   warm_s  device_busy_s  idle_share")
    for name in names:
        s = steps[name]
        print(f"{name}  {cold[name]:7.3f}  {warm[name]:7.3f}  "
              f"{s['device_busy_s']:13.4f}  {s['idle_share']:10.3f}")
        for op, ms in s["top_ops_ms"]:
            print(f"          {ms:9.3f} ms  {op[:80]}")
    for label, group in (("01-09", chip_smoke.STEP_NAMES[:9]),
                         ("01-11", chip_smoke.STEP_NAMES)):
        busy = sum(steps[n]["device_busy_s"] for n in group)
        total = sum(warm[n] for n in group)
        print(f"{label}   {sum(cold[n] for n in group):7.3f}  {total:7.3f}  "
              f"{busy:13.4f}  {1.0 - busy / total:10.3f}")
    print("step 11 host stages on the cold run (s, calls):")
    for label, (secs, calls) in stages.items():
        print(f"  {secs:8.3f}  {calls:4d}  {label}")
    print("device ops by self device time (ms, count):")
    for key, us, n in ops:
        print(f"  {us / 1e3:9.3f}  {n:6d}  {key[:100]}")
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"profile_field_{mode}.json"), "w") as fh:
        json.dump(dict(card=card, precision=mode, cold=cold, warm=warm,
                       steps=steps, step11_stages=stages,
                       ops=[dict(name=k, device_ms=us / 1e3, count=n)
                            for k, us, n in ops]), fh, indent=1)
    prof.export_chrome_trace(
        os.path.join(out, f"profile_field_{mode}_trace.json"))


if __name__ == "__main__":
    main()
