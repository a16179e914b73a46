#!/usr/bin/env python3
"""Per-step device profile of origin_tpu_torch's steps 01-07 on one GPU.

Runs steps 01-07 on the synthetic 3681x100x200 field of tools/bench_e2e.py
(seed 7, default parameters, purity 0.8) twice: once cold, once warm under
``torch.profiler``.  For each step of the warm run it prints the host wall
(with the device drained at both ends), the device-busy time (the union of
the GPU kernel and memcpy intervals inside the step's window) and the idle
share ``1 - busy / wall``; then the device ops with the most device time.
Writes chiprun_out/profile_field.json and the Chrome trace
chiprun_out/profile_field_trace.json.

Usage: python3 tools_torch/profile_field.py
"""

import json
import os
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


def main():
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    sys.path.insert(0, REPO)
    import chip_smoke
    from origin_tpu_torch.pipeline.session import ORIGIN

    bench = chip_smoke._load_file("bench_e2e", os.path.join(REPO, "tools",
                                                            "bench_e2e.py"))
    cube, _ = bench.make_field(*chip_smoke.FIELD, seed=7)
    os.makedirs(chip_smoke.WORK, exist_ok=True)

    def run(name, traced):
        orig = ORIGIN.init(cube, name=name, path=chip_smoke.WORK,
                           loglevel="WARNING", device="cuda")
        walls = {}
        for step in chip_smoke.STEP_NAMES:
            method = getattr(orig, next(m for m in dir(orig)
                                        if m.startswith(step + "_")))
            kw = dict(purity=0.8) if step == "step06" else {}
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
        return walls

    cold = run("profile_cold", traced=False)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        warm = run("profile_warm", traced=True)

    events = prof.events()
    device = [(e.time_range.start, e.time_range.end) for e in events
              if e.device_type == DeviceType.CUDA]
    steps = {}
    for e in events:
        if e.name in chip_smoke.STEP_NAMES and e.device_type == DeviceType.CPU:
            a, b = e.time_range.start, e.time_range.end
            busy = _union_us([(max(x, a), min(y, b)) for x, y in device
                              if y > a and x < b])
            wall_us = warm[e.name] * 1e6
            steps[e.name] = dict(wall_s=warm[e.name], device_busy_s=busy / 1e6,
                                 idle_share=1.0 - busy / wall_us)
    ops = sorted(((k.key, k.self_device_time_total, k.count)
                  for k in prof.key_averages()
                  if k.self_device_time_total > 0), key=lambda r: -r[1])[:20]

    card = os.popen("nvidia-smi --query-gpu=name,power.limit "
                    "--format=csv,noheader").read().strip()
    print(card)
    print("step    cold_s   warm_s  device_busy_s  idle_share")
    for name in chip_smoke.STEP_NAMES:
        s = steps[name]
        print(f"{name}  {cold[name]:7.3f}  {warm[name]:7.3f}  "
              f"{s['device_busy_s']:13.4f}  {s['idle_share']:10.3f}")
    busy = sum(s["device_busy_s"] for s in steps.values())
    total = sum(warm.values())
    print(f"total   {sum(cold.values()):7.3f}  {total:7.3f}  {busy:13.4f}  "
          f"{1.0 - busy / total:10.3f}")
    print("device ops by self device time (ms, count):")
    for key, us, n in ops:
        print(f"  {us / 1e3:9.3f}  {n:6d}  {key[:100]}")
    out = os.path.join(REPO, "chiprun_out")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "profile_field.json"), "w") as fh:
        json.dump(dict(card=card, cold=cold, warm=warm, steps=steps,
                       ops=[dict(name=k, device_ms=us / 1e3, count=n)
                            for k, us, n in ops]), fh, indent=1)
    prof.export_chrome_trace(os.path.join(out, "profile_field_trace.json"))


if __name__ == "__main__":
    main()
