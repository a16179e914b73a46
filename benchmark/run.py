"""Benchmark of origin_tpu_torch: a survey of MUSE fields through steps 01-10.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up: the port is imported, the cell's field is made on the device from
the seed and written once as a FITS file inside the checkout, and one
warm-up field runs through steps 01-10, which builds every kernel into the
checkout's ``build/`` and warms every shape.  The window then runs fields
as a survey does (``ORIGIN.init`` on the file, steps 01-10 with the CLI's
parameters, ``engine.release()``), each ending in a device sync, and
closes at the end of the first field that ends after ``--seconds``.  The
last field's products are then held to the plain reference
(``check.py``).  The last line of standard output is one JSON object.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
BANNED = {"jax", "jaxlib", "flax", "origin_tpu"}
GIB = float(2 ** 30)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def banned_modules():
    """Top-level names of loaded modules that the run must not hold,
    compared whole (``origin_tpu_torch`` is not ``origin_tpu``); a name
    blocked with ``None`` is not loaded."""
    loaded = {m.split(".")[0] for m, mod in list(sys.modules.items())
              if mod is not None}
    return sorted(loaded & BANNED)


def card_power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "not read"


class Survey:
    """One cell's survey: the field file, the session calls and spans."""

    def __init__(self, config, workdir, spans, device, root):
        from origin_tpu_torch.pipeline.session import ORIGIN

        self.ORIGIN = ORIGIN
        self.config = config
        self.workdir = workdir
        self.spans = spans
        self.device = device
        self.cube_path = os.path.join(workdir, "field.fits")
        self.fieldmap = (os.path.join(workdir, "fieldmap.fits")
                         if "fieldmap" in config else None)
        self.dico = os.path.join(root, config["dictionary"])

    def write(self, traffic, seed):
        """Makes the field from the seed and writes it (and a mosaic's
        field map) where the survey reads it."""
        from benchmark import field, fitsfile

        data, var, _ = field.make_field(self.config, traffic, seed,
                                        self.device)
        fitsfile.write_cube(self.cube_path, data, var,
                            self.config["geometry"], self.config["fsf"],
                            fields=self.config.get("fields"))
        del data, var
        if self.fieldmap is not None:
            fitsfile.write_fieldmap(self.fieldmap, (field.field_index(
                self.config, "cpu") + 1).numpy())

    def field(self):
        """One field through the configured steps; returns the session."""
        sp = self.spans.span
        with sp("init"):
            orig = self.ORIGIN.init(self.cube_path, profiles=self.dico,
                                    fieldmap=self.fieldmap,
                                    device=self.device, name="field",
                                    path=self.workdir, loglevel="WARNING")
        for method, kwargs in self.config["survey"]:
            with sp(method.split("_")[0]):
                getattr(orig, method)(**kwargs)
        return orig

    @staticmethod
    def release(orig):
        orig.close_logfile()
        orig.engine.release()


def summary(orig):
    """What each field of the window must repeat: its thresholds and the
    rows of its catalogs."""
    def rows(cat, cols):
        return sorted(tuple(int(v) for v in r)
                      for r in zip(*(list(cat[c]) for c in cols)))

    return dict(threshold=float(orig.param["threshold"]),
                threshold_std=float(orig.param["threshold_std"]),
                cat0=rows(orig.Cat0, ("x0", "y0", "z0")),
                cat1=rows(orig.Cat1, ("x0", "y0", "z0")),
                cat3=len(orig.Cat3_lines))


def read_metrics(ctx, entries):
    """Each per-layer metric by its reader; one with nothing to read is
    left out."""
    out = {}
    for m in entries:
        reader = importlib.import_module(
            f"{__package__ or 'benchmark'}.readers.{m['reader']}")
        value = reader.read(ctx, m)
        if value is not None:
            out[m["name"]] = dict(value=value, unit=m["unit"])
    return out


def main(argv=None, require_chip=True, device="cuda", root=ROOT,
         before_check=None):
    args = parse(argv)
    sys.path.insert(0, root)
    from benchmark import check, spec
    from benchmark.trace import Spans

    bench = spec.load(root)
    cell, config, traffic, e2e, per_layer = spec.resolve(
        bench, args.workload, root, os.path.join(root, "benchmark"))
    import torch

    if require_chip and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < int(cell["chips"])):
        print(f"{cell['name']} needs {cell['chips']} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    for key, val in config.get("environment", {}).items():
        os.environ[key] = str(val)

    import origin_tpu_torch.pipeline.session  # noqa: F401  the port

    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    workdir = os.path.join(root, "build", "benchmark", cell["name"])
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    try:
        survey = Survey(config, workdir, Spans(False, sync), device, root)
        survey.write(traffic, args.seed)
        survey.release(survey.field())  # warm-up: builds and shapes
        os.sync()  # no write-back of set-up's files inside the window
        gc.collect()
        sync()
        spans = Spans(args.trace == 1, sync)
        (orig, fields, wall, peak, trace, summaries, setup_s,
         walls) = window(args, survey, cuda, sync, spans)
        prog = check.products(orig)
        survey.release(orig)
        del orig
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        if before_check is not None:
            before_check(prog)
        numbers = readings(check, config, traffic, args.seed, prog, device,
                           summaries, root)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)

    limits = config["limits"]
    missing = set(limits) - set(numbers)
    if missing:
        print(f"numbers not read: {sorted(missing)}", file=sys.stderr)
        return 4
    checks, correct = check.verdict(numbers, limits)
    ctx = dict(spans=spans if args.trace else None, fields=fields,
               trace=trace, config=config, profiles=load_profiles(
                   os.path.join(root, config["dictionary"]))[0])
    if args.trace:
        metrics = read_metrics(ctx, per_layer)
    else:
        e2e_values = dict(field_s=wall / fields, peak_mem_gib=peak / GIB,
                          setup_s=setup_s)
        metrics = {m["name"]: dict(value=e2e_values[m["name"]],
                                   unit=m["unit"]) for m in e2e}
    dev = dict(platform="gpu" if cuda else "cpu",
               kind=torch.cuda.get_device_name() if cuda else "cpu",
               count=int(cell["chips"]), memory_peak_bytes=int(peak))
    line = dict(correct=correct, attempted=fields, failed=0, metrics=metrics,
                device=dev)
    if args.trace and trace is not None:
        dev.update(busy_s=trace.busy_s, window_s=trace.window_s)
        line["breakdown"] = dict(device_ops=trace.top_ops(),
                                 idle_gaps=trace.gaps(spans))
    line["field_walls_s"] = walls
    line["power_limit"] = card_power_limit() if cuda else "cpu"
    line["cat1_lines"] = len(summaries[-1]["cat1"])
    line["checks"] = checks
    found = banned_modules()
    if found:
        print(f"modules that the run must not load: {found}", file=sys.stderr)
        return 3
    print(f"Cat1 lines a field: {line['cat1_lines']}", file=sys.stderr)
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0


def window(args, survey, cuda, sync, spans):
    """Runs fields until one ends after ``args.seconds``, recording
    ``spans``; returns the last session (kept for the check), the fields,
    the wall, the peak device memory, the reduced trace, each field's
    summary, the set-up time and each field's wall (the release of the
    field before it included)."""
    import torch

    from benchmark.trace import Trace, device_intervals

    survey.spans = spans
    prof = None
    if args.trace and cuda:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0_ns = time.time_ns()
    t0 = time.perf_counter()
    setup_s = t0 - T_START
    fields, summaries, walls = 0, [], []
    while True:
        orig = survey.field()
        sync()
        fields += 1
        elapsed = time.perf_counter() - t0
        walls.append(elapsed - sum(walls))
        summaries.append(summary(orig))
        if elapsed >= args.seconds:
            break
        survey.release(orig)
        del orig
        gc.collect()
    t1_ns = time.time_ns()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    trace = None
    if prof is not None:
        prof.__exit__(None, None, None)
        trace = Trace(device_intervals(prof), t0_ns, t1_ns)
        del prof
    return orig, fields, elapsed, peak, trace, summaries, setup_s, walls


def load_profiles(path):
    """The dictionary's profiles and their FWHMs in channels."""
    from benchmark.fitsfile import read_images

    hdus = [(hdr, data) for hdr, data in read_images(path)[1:]
            if data is not None]
    return [d for _, d in hdus], [float(h["FWHM"]) for h, _ in hdus]


def reference_inputs(config, traffic, seed, device, root):
    """What the reference takes besides the program's products: the raw
    field again from the seed, the FSF cube (a mosaic: the (F, Nz, P, P)
    stack of the fields' and their (F, Ny, Nx) 0/1 weight maps from the
    configuration's rectangles; else no weights) and its FWHM in pixels
    per channel (a mosaic: the mean over the fields), the profiles, their
    FWHMs and the half length of a line's kept spectrum for each (in
    channels), the purity and step 03's false-alarm probability."""
    import math

    import numpy as np
    import torch

    from benchmark import field

    data, var, _ = field.make_field(config, traffic, seed, device)
    lbda = field.wavelengths(config, device)
    pixstep = float(config["geometry"]["pixstep_arcsec"])
    models = field.fsf_models(config)
    psfs = [field.moffat_cube(lbda, fsf, pixstep, int(config["psf_size"]))
            for fsf in models]
    lb1, lb2 = config["fsf"]["lbrange"]
    red = (lbda.cpu().numpy() - lb1) / (lb2 - lb1)
    fwhm_psf = np.mean([np.polyval(fsf["fwhm_pol"], red) / pixstep
                        for fsf in models], axis=0)
    mosaic = "fields" in config
    psf = torch.stack(psfs) if mosaic else psfs[0]
    weights = field.weight_maps(config, device) if mosaic else None
    profiles, fwhms = load_profiles(os.path.join(root, config["dictionary"]))
    survey = dict(config["survey"])
    size_fwhm = survey["step08_compute_spectra"].get("spectrum_size_fwhm", 6)
    return dict(raw=data, var=var, psf=psf, weights=weights,
                fwhm_psf=fwhm_psf,
                profiles=profiles, fwhm_profiles=fwhms,
                spectrum_radius=[int(math.ceil(f * size_fwhm / 2))
                                 for f in fwhms],
                purity=float(survey["step06_compute_purity_threshold"]
                             ["purity"]),
                pfa_test=float(survey["step03_compute_PCA_threshold"]
                               ["pfa_test"]))


def readings(check, config, traffic, seed, prog, device, summaries, root):
    """The numbers compared: the last field's products against the plain
    reference, and every field's catalogs against the last one's."""
    numbers, _ = check.readings(
        prog, reference_inputs(config, traffic, seed, device, root), device)
    last = summaries[-1]
    numbers["fields_differ"] = sum(s != last for s in summaries)
    return numbers


if __name__ == "__main__":
    sys.exit(main())
