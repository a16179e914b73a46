#!/usr/bin/env python3
"""Per-step device profile of origin_tpu_torch's steps 01-11 on one GPU.

Runs the session's init and steps 01-11 on the synthetic 3681x100x200
field (tools_torch/synthetic.py; seed 7, written to a FITS file that the
init reads, as a user's session does; default parameters, purity 0.8,
source files of version "0.1"; chip_smoke.STEP_KWARGS) twice: once cold,
once warm under ``torch.profiler``.  For the init and each step of the
warm run it prints the host wall
(with the device drained at both ends), the device-busy time (the union of
the GPU kernel and memcpy intervals inside the step's window) and the idle
share ``1 - busy / wall``, and the step's three ops with the most device
time; then the device ops with the most device time overall.  The steps'
own ``record_function`` ranges appear on the device timeline too and are
left out of both.  Each run's session folder is deleted after it.  On the
cold run, step 11's host stages are timed by wrappers (wall-clock sums and
calls: the device rounds, the two kinds of cutout, the narrow-band images,
the source files' FITS writes, each source's whole build, and the closing
session write).
Writes chiprun_out/profile_field_<mode>.json and the Chrome trace
chiprun_out/profile_field_<mode>_trace.json, <mode> the precision.

Usage: python3 tools_torch/profile_field.py  (with ORIGIN_TPU_PRECISION=bf16x3
in the environment for the bf16x3 mode)
"""

import contextlib
import json
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


class _StageTimer:
    """Wraps step 11's stages and sums their host walls while active."""

    def __init__(self):
        from origin_tpu_torch.artifacts import source, source_creation
        from origin_tpu_torch.core.containers import Cube
        from origin_tpu_torch.pipeline.products import TensorCube
        from origin_tpu_torch.pipeline.session import ORIGIN
        from origin_tpu_torch.pipeline.steps import SaveSources

        self.targets = [
            ("device rounds", SaveSources, "_device_source_artifacts"),
            ("detection-cube cutouts", TensorCube, "subcube"),
            ("raw-cube cutouts", Cube, "subcube"),
            ("narrow-band images", source.Source,
             "add_narrow_band_image_lbdaobs"),
            ("source FITS writes", source.Source, "write"),
            ("source builds (writes included)", source_creation,
             "create_source"),
            ("session write", ORIGIN, "write"),
        ]
        self.sums = {label: [0.0, 0] for label, _, _ in self.targets}

    def _wrap(self, label, fn):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.sums[label][0] += time.perf_counter() - t0
                self.sums[label][1] += 1

        return timed

    def __enter__(self):
        self.saved = []
        for label, owner, name in self.targets:
            raw = vars(owner)[name]
            fn = raw.__func__ if isinstance(raw, staticmethod) else raw
            wrapped = self._wrap(label, fn)
            if isinstance(raw, staticmethod):
                wrapped = staticmethod(wrapped)
            self.saved.append((owner, name, raw))
            setattr(owner, name, wrapped)
        return self

    def __exit__(self, *exc):
        for owner, name, raw in self.saved:
            setattr(owner, name, raw)


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    sys.path.insert(0, REPO)
    import chip_smoke
    from origin_tpu_torch.pipeline.session import ORIGIN
    from tools_torch.synthetic import make_field

    os.makedirs(chip_smoke.WORK, exist_ok=True)
    cube_fn = os.path.join(chip_smoke.WORK, "profile_field.fits")
    make_field(*chip_smoke.FIELD, seed=7)[0].write(cube_fn)
    names = ("init",) + chip_smoke.STEP_NAMES

    def run(name, traced):
        walls = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (record_function("init") if traced
              else contextlib.nullcontext()):
            orig = ORIGIN.init(cube_fn, name=name, path=chip_smoke.WORK,
                               loglevel="WARNING", device="cuda")
            torch.cuda.synchronize()
        walls["init"] = time.perf_counter() - t0
        for step in chip_smoke.STEP_NAMES:
            method = getattr(orig, next(m for m in dir(orig)
                                        if m.startswith(step + "_")))
            kw = chip_smoke.STEP_KWARGS.get(step, {})
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if traced:
                with record_function(step):
                    method(**kw)
                    torch.cuda.synchronize()
            else:
                method(**kw)
                torch.cuda.synchronize()
            walls[step] = time.perf_counter() - t0
        orig.close_logfile()
        shutil.rmtree(orig.outpath, ignore_errors=True)
        return walls

    with _StageTimer() as stages:
        cold = run("profile_cold", traced=False)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        warm = run("profile_warm", traced=True)
    os.remove(cube_fn)

    events = prof.events()
    device = [(e.time_range.start, e.time_range.end, e.name) for e in events
              if e.device_type == DeviceType.CUDA and e.name not in names]
    steps = {}
    for e in events:
        if e.name in names and e.device_type == DeviceType.CPU:
            a, b = e.time_range.start, e.time_range.end
            inside = [(max(x, a), min(y, b), name) for x, y, name in device
                      if y > a and x < b]
            busy = _union_us([(x, y) for x, y, _ in inside])
            by_op = {}
            for x, y, name in inside:
                by_op[name] = by_op.get(name, 0.0) + (y - x) / 1e3
            wall_us = warm[e.name] * 1e6
            steps[e.name] = dict(
                wall_s=warm[e.name], device_busy_s=busy / 1e6,
                idle_share=1.0 - busy / wall_us,
                top_ops_ms=sorted(by_op.items(), key=lambda r: -r[1])[:3])
    ops = sorted(((k.key, k.self_device_time_total, k.count)
                  for k in prof.key_averages()
                  if k.self_device_time_total > 0
                  and k.key not in names),
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
    for label, (secs, calls) in stages.sums.items():
        print(f"  {secs:8.3f}  {calls:4d}  {label}")
    print("device ops by self device time (ms, count):")
    for key, us, n in ops:
        print(f"  {us / 1e3:9.3f}  {n:6d}  {key[:100]}")
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, f"profile_field_{mode}.json"), "w") as fh:
        json.dump(dict(card=card, precision=mode, cold=cold, warm=warm,
                       steps=steps, step11_stages=stages.sums,
                       ops=[dict(name=k, device_ms=us / 1e3, count=n)
                            for k, us, n in ops]), fh, indent=1)
    prof.export_chrome_trace(
        os.path.join(out, f"profile_field_{mode}_trace.json"))


if __name__ == "__main__":
    main()
