#!/usr/bin/env python3
"""Smoke run of origin_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

Phases, each fatal on failure:

1. versions of the card, torch, CUDA and nvcc, and the card's name and
   power limit as ``nvidia-smi`` reports them;
2. build the CUDA GLR sweep kernel from ``origin_tpu_torch/csrc``;
3. hold the kernel against its plain torch version on the card at
   3681 x 100 x 200 for the 3- and 20-profile dictionaries, and time both
   with CUDA events;
4. steps 01-07 on the synthetic minicube (tests/make_minicube.py) with
   ``device="cuda"``;
5. steps 01-07 on the synthetic 3681 x 100 x 200 field of
   tools/bench_e2e.py (seed 7), twice (cold, then warm), with per-step
   walls and peak device memory; the sweep's launch counter must move.

In phases 4 and 5 steps 05-07 are then re-run with the plain sweep in
place of the kernel, and the two catalogs must agree row for row.  The
std threshold, which step 04 does not touch, is held within 0.02 of the
JAX package's.  What step 04 decides is held to a reference that runs the
same algorithm to convergence, because the JAX package stops its power
iteration on a float32 test that rounding decides (ROADMAP.md section 3):
on the minicube, the goldens' Cat0/Cat1 counts exactly and the correl
threshold within 1e-3 of the JAX package run with its whole power budget;
on the field, the correl threshold within 0.02 and Cat0/Cat1 within one
line of the float64 ARPACK oracle of step 04 (tools_torch/field_step04.py).

The next-to-last line of stdout is a JSON record of the kernels, the last
``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Exits non-zero without a CUDA device.

Usage: python3 chip_smoke.py
"""

import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "build", "chip_smoke")
RESULTS = os.path.join(REPO, "chiprun_out", "chip_smoke.json")

FIELD = (3681, 100, 200)
# steps 01-07 of the JAX package on the CPU (same fields, same parameters)
GOLD_MINI = dict(threshold=4.5908, threshold_std=4.8666, cat0=15, cat1=14)
GOLD_FIELD = dict(threshold=5.1978, threshold_std=5.2896, cat0=76, cat1=68)
# minicube correl threshold of the JAX package with its power iteration run
# to its whole budget (tests/jax_full_budget.py), as the port runs it
FULL_BUDGET_MINI_THRESHOLD = 4.564202
# the field with step 04 from the float64 oracle, steps 05-07 from the port
# on an H100 (tools_torch/field_step04.py)
ORACLE_FIELD = dict(threshold=5.224504, cat0=66, cat1=58)
THRESH_TOL = 0.02
COUNT_TOL = 1
SWEEP_ATOL = SWEEP_RTOL = 1e-5
TIE_TOL = 1e-5


def log(*args):
    print(*args, flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")
    log(f"  ok: {what}")


def _load_file(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sync_wall(fn):
    """Host wall of ``fn()`` with the device drained on both sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


# -- phase 1 ----------------------------------------------------------------
def phase_versions():
    import torch

    from origin_tpu_torch.ops import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, "nvidia-smi reads the card")
    card = smi.stdout.strip().splitlines()[0]
    nvcc = build._find_nvcc()
    check(nvcc is not None, "nvcc found")
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[-1]
    log(f"python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  nvcc: {ver}")
    log(f"device: {torch.cuda.get_device_name(0)} "
        f"(count {torch.cuda.device_count()})")
    log(card)
    return dict(nvidia_smi=card, torch=torch.__version__,
                cuda=torch.version.cuda, nvcc=ver,
                device=torch.cuda.get_device_name(0))


# -- phase 2 ----------------------------------------------------------------
def phase_build():
    from origin_tpu_torch.ops import build

    t0 = time.perf_counter()
    build.load_library("toeplitz_sweep")
    info = build.BUILD_INFO["toeplitz_sweep"]
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {info['seconds']:.2f} s, cached={info['cached']})")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log("  ptxas:", line.strip())
    return dict(build_s=info["seconds"], cached=info["cached"],
                ptxas=info["ptxas"])


# -- phase 3 ----------------------------------------------------------------
def _banks(dico, nz, dev):
    import torch

    from origin_tpu.core.profiles import default_dictionary_path, load_dictionary
    from origin_tpu_torch.ops.glr import pack_profiles_toeplitz, prepare_profiles

    profiles, _ = load_dictionary(default_dictionary_path(dico))
    t_num, t_den, pad_left, _ = pack_profiles_toeplitz(
        prepare_profiles(profiles), block=min(128, nz))
    return (torch.from_numpy(t_num).to(dev), torch.from_numpy(t_den).to(dev),
            pad_left)


def _t_values(x, n, taps_num, taps_den, pad_left, z, s, k):
    """float64 t_k at voxels (z, s) for profiles k, from the taps."""
    import torch

    reach = taps_num.shape[1]
    j = torch.arange(reach, device=x.device)
    zi = z[:, None] + j[None, :] - pad_left
    ok = (zi >= 0) & (zi < x.shape[0])
    zi = zi.clamp(0, x.shape[0] - 1)
    xs = torch.where(ok, x[zi, s[:, None]], 0).double()
    ns = torch.where(ok, n[zi, s[:, None]], 0).double()
    num = (xs * taps_num[k].double()).sum(1)
    den = (ns * taps_den[k].double()).sum(1)
    return num / torch.where(den <= 0, float("inf"), den.sqrt())


def _time_cuda(fn, reps):
    import torch

    fn()  # warm
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_sweep_parity():
    import torch

    from origin_tpu.core.profiles import DICO_3FWHM, DICO_FWHM_2_12
    from origin_tpu_torch.ops.glr import toeplitz_sweep
    from origin_tpu_torch.ops.sweep import spectral_sweep, sweep_taps

    dev = torch.device("cuda")
    nz, ny, nx = FIELD
    g = torch.Generator(device=dev).manual_seed(20261016)
    x = torch.randn(FIELD, generator=g, device=dev)
    n = torch.rand(FIELD, generator=g, device=dev) * 1.5 + 0.5
    out = {}
    for dico in (DICO_3FWHM, DICO_FWHM_2_12):
        t_num, t_den, pad_left = _banks(dico, nz, dev)
        k = t_num.shape[0]
        c, p, m = spectral_sweep(x, n, t_num, t_den, pad_left, nz)
        torch.cuda.synchronize()
        cr, pr, mr = toeplitz_sweep(x, n, t_num, t_den, pad_left, nz)
        err = max(float((c - cr).abs().max()), float((m - mr).abs().max()))
        close = all(bool(((a - b).abs() <= SWEEP_ATOL + SWEEP_RTOL
                          * b.abs()).all()) for a, b in ((c, cr), (m, mr)))
        check(p.dtype == pr.dtype, f"K={k}: profile dtype {p.dtype}")
        check(close, f"K={k}: correl/cmin within atol {SWEEP_ATOL} + rtol "
              f"{SWEEP_RTOL} of the plain sweep (max abs err {err:.3g})")
        bad = (p != pr).reshape(nz, -1).nonzero()
        gap = 0.0
        if bad.numel():
            taps_num, taps_den, _, _ = sweep_taps(t_num, t_den)
            z, s = bad[:, 0], bad[:, 1]
            xf, nf = x.reshape(nz, -1), n.reshape(nz, -1)
            ka = p.reshape(nz, -1)[z, s].long()
            kb = pr.reshape(nz, -1)[z, s].long()
            ta = _t_values(xf, nf, taps_num, taps_den, pad_left, z, s, ka)
            tb = _t_values(xf, nf, taps_num, taps_den, pad_left, z, s, kb)
            gap = float((ta - tb).abs().max())
        check(gap <= TIE_TOL, f"K={k}: {bad.shape[0]} profile mismatches, "
              f"all near-ties (max |t_a - t_b| {gap:.3g} <= {TIE_TOL})")
        del c, p, m, cr, pr, mr
        ms = _time_cuda(lambda: spectral_sweep(x, n, t_num, t_den, pad_left,
                                               nz), reps=10)
        plain_ms = _time_cuda(lambda: toeplitz_sweep(x, n, t_num, t_den,
                                                     pad_left, nz), reps=3)
        log(f"  K={k}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
            f"({nz}x{ny}x{nx})")
        out[k] = dict(max_abs_err=err, mismatches=int(bad.shape[0]),
                      tie_gap=gap, ms=ms, plain_ms=plain_ms)
    return out


# -- phases 4 and 5 -----------------------------------------------------------
STEP_NAMES = ("step01", "step02", "step03", "step04", "step05", "step06",
              "step07")


def _run_steps(orig, step_kwargs):
    walls = {}
    for name in STEP_NAMES:
        method = next(getattr(orig, m) for m in dir(orig)
                      if m.startswith(name + "_"))
        walls[name] = sync_wall(lambda: method(**step_kwargs.get(name, {})))
    return walls


def _catalog_rows(cat):
    import numpy as np

    cols = ("ID", "x0", "y0", "z0", "comp", "profile")
    return np.stack([np.asarray(cat[c], np.int64) for c in cols], axis=1)


def _rerun_with_plain_sweep(orig, step_kwargs):
    """Steps 05-07 again with the plain sweep in place of the kernel."""
    import numpy as np

    from origin_tpu_torch.ops import glr
    from origin_tpu_torch.pipeline import engine

    rows, tglr = _catalog_rows(orig.Cat1), np.asarray(orig.Cat1["T_GLR"])
    thr = (orig.param["threshold"], orig.param["threshold_std"])
    kernel = engine.spectral_sweep
    engine.spectral_sweep = glr.toeplitz_sweep
    try:
        for name in ("step05", "step06", "step07"):
            method = next(getattr(orig, m) for m in dir(orig)
                          if m.startswith(name + "_"))
            method(**step_kwargs.get(name, {}))
    finally:
        engine.spectral_sweep = kernel
    same_rows = (rows.shape == _catalog_rows(orig.Cat1).shape
                 and bool((rows == _catalog_rows(orig.Cat1)).all()))
    plain_t = np.asarray(orig.Cat1["T_GLR"])
    t_ok = same_rows and bool(np.allclose(tglr, plain_t, rtol=1e-4,
                                          equal_nan=True))
    dthr = max(abs(thr[0] - orig.param["threshold"]),
               abs(thr[1] - orig.param["threshold_std"]))
    check(same_rows and t_ok and dthr <= 1e-3,
          f"steps 05-07 with the plain sweep: same Cat1 rows and T_GLR "
          f"(rtol 1e-4), thresholds within {dthr:.2g} <= 1e-3")


def _recovered(cat, lines):
    import numpy as np

    x0, y0, z0 = (np.asarray(cat[c]) for c in ("x0", "y0", "z0"))
    hit = [bool(((np.abs(x0 - x) <= 2) & (np.abs(y0 - y) <= 2)
                 & (np.abs(z0 - z) <= 4)).any()) for x, y, z in lines]
    return sum(hit), len(hit)


def _summary(orig, gold):
    out = dict(threshold=float(orig.param["threshold"]),
               threshold_std=float(orig.param["threshold_std"]),
               cat0=len(orig.Cat0), cat1=len(orig.Cat1),
               sources=len(set(int(i) for i in orig.Cat1["ID"])),
               mapO2_max=int(orig.mapO2.data.max()))
    log("  thresholds %.6f / %.6f (JAX %.4f / %.4f), Cat0 %d (JAX %d), "
        "Cat1 %d lines in %d sources (JAX %d lines)" % (
            out["threshold"], out["threshold_std"], gold["threshold"],
            gold["threshold_std"], out["cat0"], gold["cat0"], out["cat1"],
            out["sources"], gold["cat1"]))
    return out


def phase_minicube():
    import numpy as np

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from make_minicube import BRIGHT_LINES, FAINT_LINES, make_minicube, make_segmap

    from origin_tpu_torch.pipeline.session import ORIGIN

    cube_fn = os.path.join(WORK, "minicube.fits")
    seg_fn = os.path.join(WORK, "segmap.fits")
    make_minicube(cube_fn)
    make_segmap(seg_fn)
    kwargs = dict(step02=dict(minsize=30, maxsize=60),
                  step06=dict(purity=0.8), step07=dict(segmap=seg_fn))
    orig = ORIGIN.init(cube_fn, name="minicube", path=WORK,
                       loglevel="WARNING", device="cuda")
    walls = _run_steps(orig, kwargs)
    log("  walls: " + " ".join(f"{k} {v:.2f}s" for k, v in walls.items()))
    out = _summary(orig, GOLD_MINI)
    check(abs(out["threshold_std"] - GOLD_MINI["threshold_std"])
          <= THRESH_TOL, "minicube std threshold within 0.02 of JAX")
    gap = out["threshold"] - FULL_BUDGET_MINI_THRESHOLD
    gold_gap = out["threshold"] - GOLD_MINI["threshold"]
    check(abs(gap) <= 1e-3, f"minicube correl threshold within 1e-3 of JAX "
          f"with the whole power budget ({gap:+.2g}; {gold_gap:+.4f} from "
          f"the goldens' early-stopped {GOLD_MINI['threshold']})")
    check(all(out[k] == GOLD_MINI[k] for k in ("cat0", "cat1")),
          "minicube Cat0 and Cat1 equal the goldens")
    lines = [(x, y, z) for x, y, z, _, _ in FAINT_LINES + BRIGHT_LINES]
    got, tot = _recovered(orig.Cat1, lines)
    check(got == tot, f"minicube: {got}/{tot} injected lines in Cat1")
    _rerun_with_plain_sweep(orig, kwargs)
    orig.close_logfile()
    out["walls"] = walls
    return out


def phase_field():
    import torch

    from origin_tpu_torch.ops.sweep import spectral_sweep
    from origin_tpu_torch.pipeline.session import ORIGIN

    bench = _load_file("bench_e2e", os.path.join(REPO, "tools",
                                                  "bench_e2e.py"))
    t0 = time.perf_counter()
    cube, lines = bench.make_field(*FIELD, seed=7)
    log(f"  field {FIELD} generated in {time.perf_counter() - t0:.1f} s")
    kwargs = dict(step06=dict(purity=0.8))
    runs = {}
    for run in ("cold", "warm"):
        gc.collect()  # the session <-> engine cycle holds the last run's cubes
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        if run == "cold":
            spectral_sweep.launches = 0
        orig = ORIGIN.init(cube, name=f"field_{run}", path=WORK,
                           loglevel="WARNING", device="cuda")
        walls = _run_steps(orig, kwargs)
        if run == "cold":
            launches = spectral_sweep.launches
        peak = torch.cuda.max_memory_allocated()
        log(f"  {run}: " + " ".join(f"{k} {v:.3f}s" for k, v in walls.items())
            + f"  total {sum(walls.values()):.3f}s  peak {peak / 2**30:.2f}"
            " GiB")
        runs[run] = dict(walls=walls, total=sum(walls.values()),
                         peak_bytes=peak, **_summary(orig, GOLD_FIELD))
        if run == "cold":
            check(launches > 0, f"main path launched the sweep kernel "
                  f"({launches} launches)")
            bright = [(x, y, z) for x, y, z, kind in lines if kind == "bright"]
            faint = [(x, y, z) for x, y, z, kind in lines if kind == "faint"]
            gb, nb = _recovered(orig.Cat1, bright)
            gf, nf = _recovered(orig.Cat1, faint)
            log(f"  injected lines recovered: bright {gb}/{nb}, "
                f"faint {gf}/{nf}")
            runs[run].update(bright=[gb, nb], faint=[gf, nf])
            got = runs[run]
            check(abs(got["threshold_std"] - GOLD_FIELD["threshold_std"])
                  <= THRESH_TOL, f"field std threshold within {THRESH_TOL} "
                  "of JAX")
            check(abs(got["threshold"] - ORACLE_FIELD["threshold"])
                  <= THRESH_TOL, f"field correl threshold within "
                  f"{THRESH_TOL} of the step-04 oracle's "
                  f"{ORACLE_FIELD['threshold']} (JAX's early-stopped "
                  f"{GOLD_FIELD['threshold']})")
            for key in ("cat0", "cat1"):
                check(abs(got[key] - ORACLE_FIELD[key]) <= COUNT_TOL,
                      f"field {key} {got[key]} within {COUNT_TOL} line of "
                      f"the step-04 oracle's {ORACLE_FIELD[key]} (JAX's "
                      f"early-stopped {GOLD_FIELD[key]})")
            check(gb == nb, "field: every bright injected line in Cat1")
            _rerun_with_plain_sweep(orig, kwargs)
        orig.close_logfile()
        del orig
    return runs, launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import origin_tpu_torch  # noqa: F401  (fails outside the repository)

    os.makedirs(WORK, exist_ok=True)
    res = {}
    log("[1] versions")
    res["versions"] = phase_versions()
    log("[2] build")
    res["build"] = phase_build()
    log("[3] sweep kernel vs plain at %dx%dx%d" % FIELD)
    res["sweep"] = phase_sweep_parity()
    log("[4] minicube steps 01-07 on cuda")
    res["minicube"] = phase_minicube()
    log("[5] field %dx%dx%d steps 01-07 on cuda" % FIELD)
    res["field"], launches = phase_field()
    jaxed = [m for m in sys.modules if m == "jax" or m.startswith(
        ("jax.", "origin_tpu.ops", "origin_tpu.pipeline", "origin_tpu.detect"))]
    check(not jaxed, "nothing of JAX or of the JAX package's device code "
          "was imported")

    os.makedirs(os.path.dirname(RESULTS), exist_ok=True)
    with open(RESULTS, "w") as fh:
        json.dump(res, fh, indent=1, default=str)
    k3 = res["sweep"][3]
    log(res["versions"]["nvidia_smi"])
    log(json.dumps({"kernels": [{
        "name": "toeplitz_sweep", "route": "cuda",
        "source": "origin_tpu_torch/csrc/toeplitz_sweep.cu",
        "replaces": "origin_tpu/ops/pallas_sweep.py:42",
        "launches": launches, "max_abs_err": k3["max_abs_err"],
        "ms": k3["ms"], "plain_ms": k3["plain_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
