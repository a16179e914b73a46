#!/usr/bin/env python3
"""Smoke run of origin_tpu_torch, the PyTorch/CUDA port, on one NVIDIA GPU.

Phases, each fatal on failure:

1. versions of the card, torch, CUDA and nvcc, and the card's name and
   power limit as ``nvidia-smi`` reports them;
2. build every CUDA source of ``origin_tpu_torch/csrc`` (one ``nvcc`` per
   source, all started together) and print each one's ptxas register and
   spill lines; ptxas fails the build of any kernel that spills or uses
   local memory (``ops/build.py:NVCC_FLAGS``), so the sweep kernels'
   register blocking holds;
3. hold the GLR sweep kernel against its plain torch version on the card
   at 3681 x 100 x 200 for the 3- and 20-profile dictionaries, time both
   with CUDA events, and print the kernel's share of its bound;
4. steps 01-11 on the synthetic minicube (tools_torch/synthetic.py) with
   ``device="cuda"``: Cat2 row for row against the JAX package's
   (``GOLD_CAT2``, from tools_torch/minicube_cat2.py), Cat3 against the
   goldens (14 lines, 13 sources, 2 of comp=1), and the 13 source files
   against the JAX package's (``GOLD_SOURCES``, same tool): each source's
   mask triple (edge, object pixels, sky pixels) exactly, each file's
   REFSPEC and number of extensions, the L2 norms of its MUSE_TOT and
   REFSPEC spectra at rtol 1e-4;
5. steps 01-11 on the synthetic 3681 x 100 x 200 field
   (tools_torch/synthetic.make_field, seed 7, written to a FITS file
   under build/chip_smoke), twice (cold, then warm), with per-step walls,
   the peak device memory through step 09 and through step 11 (within 2%
   of each other), the number and bytes of the source files, and step
   11's closing session write (its wall, files and bytes, and step 11's
   wall with and without it, beside the dense write's; the kind of each
   of the ten cube product files, which must be the JAX package's
   defaults: three recipes, four sparse scaled-int16 tables, two
   scaled-int16 images, the dense uint8 profile cube); the sweep's launch
   counter must move; on
   the cold run, step 08's line estimation of the first 16 Cat1 rows on
   the card against the port's own on the CPU, every line max image of
   steps 10-11 bit for bit against ``ops.cutouts.line_max_images`` on the
   CPU from the host copy of its detection cube, the spectra of the first
   8 sources against ``ops.spectra.source_spectra`` on the CPU (within
   1e-5 of each spectrum's largest magnitude), and the detection-cube
   cutout of the first 4 source files exactly against the host cube's
   ``subcube`` (the detection cubes as they were before the closing write
   stored them in their compact forms).  Each session folder is deleted
   after its checks;
a. the spatial FSF kernel against its plain version at 3681 x 100 x 200,
   at ``highest`` and in bf16x3, with two weighted fields on a 256-channel
   cut, and on a 300 x 300 x 256 cut; CUDA-event times of the kernel, the
   plain version (at ``highest`` the cuBLAS chain the engine runs there)
   and one depthwise ``conv2d`` call (the library yardstick);
b. the bf16x3 sweep kernel (a banded matmul on the tensor cores) against
   its plain version (K=3 and K=20), with the RMS check that it computes
   the three bf16 passes; its time, share of its bound and ratio to the
   float32 kernel's time of phase 3;
c. the spaxel-major sweeps ``matched_filter_spectral`` and
   ``banded_matmul_spectral`` at 3681 x 100 x 200, K=3 and K=20, each
   called once through its entry point: against their plain versions, and
   bit for bit against the float32 sweep's outputs on the cube layout;
   CUDA-event times of one kernel launch (taps and outputs prebuilt), of
   the entry and of the plain version, and the kernel's share of its
   bound;
d. steps 01-07 of the minicube and of the field with
   ``ORIGIN_TPU_PRECISION=bf16x3``: the spatial and bf16x3 sweep counters
   must move; the minicube's Cat0/Cat1 equal the ``highest`` run's and
   its correl threshold is within 1e-3 of it; the field's Cat0/Cat1 are
   within one line of the ``highest`` run's and its correl threshold
   within 0.005;
e. resume on the card: session B runs steps 01-04 of the field file and
   writes itself in dense files (the three ``ORIGIN_TPU_STORE_*`` knobs
   at 0 around its write only); session C loads B's folder (``ORIGIN.load(...,
   device="cuda")``) and runs steps 05-11 with the launch counters set to
   0 just before: the float32 sweep must launch, on the cube_faint read
   back from B's file; C's thresholds equal those of phase 5's cold run
   (the uninterrupted reference), its Cat0 and Cat1 row for row (integer
   columns exact, floats at rtol 1e-6), Cat2 and Cat3 likewise, and it
   writes as many source and mask files.  Printed: B's write wall, C's
   load wall, and the first-fetch seconds (FITS read, host rebuild,
   upload) of cube_faint and of the five step-05 cubes (these from C's
   compact closing write);
f. the compact resume: session B2 runs steps 01-04 of the field file and
   writes itself with the default knobs (three recipes, two sparse
   tables); C2 loads it on the card, its first fetches of cube_std and
   cube_faint are timed (FITS read, host rebuild from the recipe, upload)
   and the rebuilt cube_faint is held within 1e-3 of B2's live tensor;
   C2 runs steps 05-11 with the counters set to 0 just before: the float32
   sweep must launch, the correl threshold lie within 1e-3 of phase 5's
   cold run and Cat0/Cat1 within one line of it; C2's closing write must
   leave the ten default kinds, and its folder, loaded once more, must
   hold each int16 or sparse product as the encoder's integers and scale
   of the live tensor it was written from, bit for bit, each value
   decoded within half a step of the live one (HALF_STEP_TOL) but the
   extrema that the sparse form clamps to one step;
g. the session's user surface on the card, on the field file at
   ``highest``: the CLI (``origin_tpu_torch.__main__.main``, in this
   process) runs the field with phase 5's parameters, with the counters
   set to 0 just before: the float32 sweep must launch and the CLI's
   Cat0, Cat1 and Cat3 equal phase 5's cold run bit for bit; its
   ``status`` lists the 11 steps as DUMPED and ``info`` prints the log; a
   fresh session's steps 01-04 are exported with ``write(...,
   compat="reference")`` and the export, loaded on the card, runs steps
   05-11 (the float32 sweep must launch on the exported cube_faint; the
   thresholds, Cat0-Cat3 and file counts as in phase e); the CLI's compact
   session, loaded on the card, is exported the same way (its first
   fetches and the export timed apart) and each dense cube file must equal
   what the loaded session's fetch gives, bit for bit; on that session the
   first Cat3 source with two lines or more is split and merged back to
   the original tables, and ``update_masks`` (on the resident detection
   cubes) and ``update_sources`` refresh the first three sources, whose
   masks must equal step 10's files and whose source files step 11's, by
   the rules of tests/test_torch_pipeline.py's
   ``assert_same_source_files``;
h. the full 3681 x 300 x 300 MUSE field (tools_torch/synthetic.make_field,
   seed 7, the generator's default source counts, written to a FITS file
   under build/chip_smoke and deleted after the phase), steps 01-11 twice
   with each step's wall and peak device memory: h1 in the normal mode
   (``ORIGIN_TPU_HBM_BYTES`` unset: the session must not be tight), h2 in
   the tight mode under ``ORIGIN_TPU_HBM_BYTES=16e9`` (the environment
   restored after it).  The float32 sweep must launch once in each run,
   the spatial kernel never in h2; after h2's steps 01, 04 and 05 the
   products it offloads and the raw inputs must hold no device memory;
   h2's peak must be within the budget and below h1's, its Cat0/Cat1
   within one line of h1's and its correl threshold within 1e-3 (the
   modes' spatial stages differ in float32 order only); step 11 writes
   one file per Cat3 source; a session of the 3681 x 100 x 200 field
   under the same budget must not be tight.  Each run's init wall, its
   split (decode, host side of the staged copies) and step 01's wait on
   the copies are printed;
i. the multi-device path on one card: mesh sessions of the field whose
   slots all name ``cuda:0`` (i1-i4), and the two mosaic tools (i5);
j. the streamed ingest: j1 initializes sessions of the field file by the
   streamed reader and, under ``ORIGIN_TPU_STREAM_INGEST=0``, by the eager
   one (whose copies start right after the read); their device inputs
   must be equal bit for bit; printed are each init's wall and split,
   how long step 01's join waits on the copy stream (CUDA events), step
   01's wall, and, from one profiled init of each route, the kind of its
   host-to-device copies (the data and variance must go Pinned ->
   Device) and their rate in GB/s; j2 runs the CLI survey of two copies
   of the field file and a bad file (``--no-sources``) without and with
   ``--overlap-ingest``: rc 1, the float32 sweep launched once per good
   field, each good field's Cat0/Cat1 equal to phase 5's cold run bit
   for bit, the two walls printed;
k. the library surface, through the top-level names of
   ``origin_tpu_torch``, on the products of phase 5's cold run:
   ``Correlation_GLR_test(cube_faint, PSF, None, Dico_3FWHM,
   device="cuda")`` must launch kernel 1 once and nothing else, and its
   output must hold to the plain sweep on the same spatial stage computed
   again on the card (``_hold_sweep``) and to the session's cube_correl
   (atol 1e-5 where the session did not mask); ``glr_spectral`` on that
   spatial stage must launch kernel 3 once and nothing else, hold to
   ``matched_filter_plain`` and equal ``glr_spectral_mxu`` (kernel 1) bit
   for bit, which must equal ``Correlation_GLR_test``'s output bit for
   bit; ``Compute_threshold_purity(0.8, cube_local_max, cube_local_min,
   segmap)`` on step 06's grid must give the session's correl threshold
   and purity table exactly, and on its own auto grid (the float64
   linspace of the JAX package's single form) the same counts and a
   threshold within 1e-3; each call's wall by CUDA events is printed
   beside the card's name and power limit.

Every fresh session of a field file runs the streamed ingest by default,
so phases 5 and e-h hold it too (phases 5 and h check that their
sessions took it).

In phases 4, 5 and d, steps 05-07 are then re-run with the plain versions
in place of the kernels (after the step 08-11 checks: the re-run replaces
the Cat1 under Cat2), and the two catalogs must agree row for row; after
step 11, whose write stored the inputs of step 05 in their compact
forms, steps 05-07 first run again with the kernels on those inputs.  The
std threshold, which step 04 does not touch, is held within 0.02 of the
JAX package's.  What step 04 decides is held to a reference that runs the
same algorithm to convergence, because the JAX package stops its power
iteration on a float32 test that rounding decides (ROADMAP.md section 3):
on the minicube, the goldens' Cat0/Cat1 counts exactly and the correl
threshold within 1e-3 of the JAX package run with its whole power budget;
on the field, the correl threshold within 0.02 and Cat0/Cat1 within one
line of the float64 ARPACK oracle of step 04 (tools_torch/field_step04.py).

Every launch counter is set to 0 just before a main-path run and read
just after it: phase 5's cold run for the float32 sweep, phase d's field
run for the spatial kernel and the bf16x3 sweep, phase c's entry calls for
the spaxel-major sweeps, phase e's and phase f's resumed steps 05-11,
phase g's CLI run and resumed export, phase h's two full-field runs and
phase j's two surveys for the float32 sweep again, phase k's
``Correlation_GLR_test`` for the float32 sweep and its ``glr_spectral``
for the spaxel-major matched filter (the launches that the kernel line
reports for it).  The next-to-last line
of stdout is a JSON record of the kernels, the line before it the card's
name and power limit, the last ``{"ok": true, "device": {...}}``.  Details go to
``chiprun_out/chip_smoke.json``.  Exits non-zero without a CUDA device.

Usage: python3 chip_smoke.py
"""

import gc
import json
import os
import shutil
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
# the minicube's Cat2 from the JAX package on the CPU with its power
# iterations run to their whole budget (tools_torch/minicube_cat2.py)
GOLD_CAT2 = dict(
    x=[18, 16, 16, 20, 52, 0, 45, 56, 12, 34, 30, 8, 42, 59],
    y=[22, 23, 11, 25, 52, 10, 20, 13, 40, 0, 45, 6, 38, 19],
    z=[45, 98, 80, 120, 139, 152, 200, 244, 260, 277, 320, 429, 300, 457],
    num_line=[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14],
    flux=[68.60468292236328, 147.89857482910156, 122.33650207519531,
          790.5428466796875, 467.3609924316406, 121.97797393798828,
          345.7584533691406, 48.7840576171875, 141.0355682373047,
          79.29041290283203, 87.35733795166016, -38.749977111816406,
          950.5963134765625, -3.566831588745117],
    residual=[0.8736013174057007, 0.6585911512374878, 0.7850394248962402,
              0.5180816054344177, 0.26825445890426636, 0.8076494336128235,
              0.2953587472438812, 0.8904994130134583, 0.4243279695510864,
              0.838723361492157, 0.6715388298034668, 0.7627037763595581,
              0.41173744201660156, 0.8659765124320984],
)
# Cat3 of tests/test_pipeline.py: lines, sources, sources of comp=1
GOLD_CAT3 = (14, 13, 2)
# the minicube's source files from the JAX package on the CPU, run as for
# GOLD_CAT2 and with ORIGIN_TPU_CORREL_WIRE=f32 (tools_torch/minicube_cat2.py):
# per source ID, (mask edge, object pixels, sky pixels, REFSPEC, number of
# extensions, L2 norm of MUSE_TOT, L2 norm of the REFSPEC spectrum)
GOLD_SOURCES = {
    1: (25, 159, 430, "ORI_CORR_2_SKYSUB", 41, 4673.774634964793,
        67.45812815653524),
    2: (25, 54, 507, "ORI_CORR_3_SKYSUB", 33, 180.1102294329428,
        5.503397964338199),
    3: (25, 101, 503, "ORI_CORR_4_SKYSUB", 33, 5025.122177528683,
        136.29694658928182),
    4: (25, 111, 241, "ORI_CORR_5_SKYSUB", 33, 292.0688697907626,
        7.150739965915426),
    5: (25, 68, 251, "ORI_CORR_6_SKYSUB", 33, 155.2867723672633,
        5.449331539623059),
    6: (25, 97, 514, "ORI_CORR_7_SKYSUB", 33, 242.34013634852593,
        6.753069961149289),
    7: (25, 77, 324, "ORI_CORR_8_SKYSUB", 33, 205.17086727920278,
        4.722332019682865),
    8: (25, 76, 522, "ORI_CORR_9_SKYSUB", 33, 205.04289744291552,
        6.049680403839657),
    9: (25, 56, 289, "ORI_CORR_10_SKYSUB", 33, 142.63130621577298,
        6.5780410710374335),
    10: (25, 51, 486, "ORI_CORR_11_SKYSUB", 33, 170.85150513054575,
         6.286801972503644),
    11: (25, 70, 329, "ORI_CORR_12_SKYSUB", 33, 197.32800408933693,
         4.969663515178269),
    12: (25, 57, 448, "ORI_CORR_13_SKYSUB", 33, 4560.76781967836,
         244.44002771149906),
    13: (25, 49, 296, "ORI_CORR_14_SKYSUB", 33, 116.76926421107858,
         14.040351244935374),
}
SOURCE_NORM_RTOL = 1e-4
# step 11's spectra on the card against the CPU: float32 sums in another
# order, held as tests/test_torch_gpu.py holds them
SPECTRA_REL = 1e-5
# sources whose spectra, and files whose detection-cube cutout, the field's
# cold run repeats on the CPU
FIELD_CPU_SOURCES = 8
FIELD_CUTOUT_FILES = 4
# steps 10-11 may not raise the field's peak device memory by more than this
PEAK_GROWTH = 1.02
# step 08 against the JAX package, as tests/test_torch_pipeline.py holds
# it: flux and residual relative, a line within LINE_RTOL of its largest
# magnitude
FLUX_RTOL = RESIDUAL_RTOL = LINE_RTOL = 1e-4
# Cat1 rows whose line estimation the field's cold run repeats on the CPU
FIELD_CPU_ROWS = 16
THRESH_TOL = 0.02
COUNT_TOL = 1
SWEEP_ATOL = SWEEP_RTOL = 1e-5
TIE_TOL = 1e-5
# the spatial kernel against its plain version, values of order 1: float32
# sums in another order; in bf16x3 a one-ulp difference of an intermediate
# can also move a split's low half by one bf16 step (the largest reading on
# an H100 is 4.65e-6, on the field)
SPATIAL_ATOL = dict(highest=1e-5, bf16x3=1e-5)
# bf16x3 and highest differ by about as much at their largest as the kernel
# and its plain version may, so the split is shown by RMS distances: the
# bf16x3 kernel lies at least SPLIT_SEPARATION times the highest kernel's
# float32 order noise (its RMS distance from its plain version) away from
# the highest kernel, and at least SPLIT_NEARER times nearer its own plain
# version than the highest kernel.  A one-ulp change upstream moves a split
# by a bf16 step, so the bf16x3 kernel and its plain version part by about
# half the bf16x3 - highest gap (ratio 2.26 on the field, H100)
SPLIT_SEPARATION = 4.0
SPLIT_NEARER = 1.5
# bf16x3 against highest (phase d)
BF16X3_MINI_THRESH_TOL = 1e-3
BF16X3_FIELD_THRESH_TOL = 0.005
# phase e: the resumed session's catalog floats against the uninterrupted
# run's (the same kernels on the same card and the same bits in between)
RESUME_RTOL = 1e-6
CATALOGS = ("Cat0", "Cat1", "Cat2", "Cat3_lines", "Cat3_sources")
# the cube products of step 05, parked by step 11's closing write
STEP05_CUBES = ("cube_correl", "cube_correl_min", "cube_profile",
                "cube_local_max", "cube_local_min")
# the kind of file each cube product is stored in by default, as the JAX
# package stores it: recipes (the ORITPURE kind), sparse scaled-int16
# tables, scaled-int16 images, dense uint8
PRODUCT_KINDS = dict(
    cube_std="dct_std", cont_dct="dct_cont", cube_faint="pca_faint",
    cube_std_local_min="sparse", cube_std_local_max="sparse",
    cube_local_min="sparse", cube_local_max="sparse", cube_correl="int16",
    cube_correl_min="int16", cube_profile="uint8")
STORE_KNOBS = ("ORIGIN_TPU_STORE_RECIPES", "ORIGIN_TPU_STORE_SPARSE",
               "ORIGIN_TPU_STORE_INT16")
# phase f: a scaled-int16 value decodes within half a step of the value it
# was quantized from, plus the float32 rounding of x / scale (up to 2**-9
# of a step at |q| < 2**15) and of the decode
HALF_STEP_TOL = 0.505
# the field's closing write in dense files (PERF.md section 6; NVIDIA H100
# 80GB HBM3, 700 W)
DENSE_WRITE = "2.74 GB in 2.98-3.40 s"

# the card's peak rates (NVIDIA H100 SXM data sheet, dense)
PEAK_FP32 = 67e12       # FLOP/s on the CUDA cores
PEAK_BF16 = 989e12      # FLOP/s on the tensor cores
PEAK_BYTES = 3.35e12    # HBM bytes/s

KERNEL_SOURCES = dict(
    toeplitz_sweep=("origin_tpu_torch/csrc/toeplitz_sweep.cu",
                    "origin_tpu/ops/pallas_sweep.py:42"),
    toeplitz_sweep_bf16x3=("origin_tpu_torch/csrc/sweep_bf16x3.cu",
                           "origin_tpu/ops/pallas_sweep.py:42"),
    spatial_fsf=("origin_tpu_torch/csrc/spatial_fsf.cu",
                 "origin_tpu/ops/pallas_spatial.py:44"),
    matched_filter_spectral=("origin_tpu_torch/csrc/toeplitz_sweep.cu",
                             "origin_tpu/ops/pallas_kernels.py:49"),
    banded_matmul_spectral=("origin_tpu_torch/csrc/toeplitz_sweep.cu",
                            "origin_tpu/ops/pallas_kernels.py:157"),
)


def log(*args):
    print(*args, flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")
    log(f"  ok: {what}")


def sync_wall(fn):
    """Host wall of ``fn()`` with the device drained on both sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def _counters():
    """(name, owner, attribute) of every kernel's launch counter."""
    from origin_tpu_torch.ops import kernels
    from origin_tpu_torch.ops.spatial import spatial_fsf
    from origin_tpu_torch.ops.sweep import spectral_sweep

    return (("toeplitz_sweep", spectral_sweep, "launches"),
            ("toeplitz_sweep_bf16x3", spectral_sweep, "launches_bf16x3"),
            ("spatial_fsf", spatial_fsf, "launches"),
            ("matched_filter_spectral", kernels.matched_filter_spectral,
             "launches"),
            ("banded_matmul_spectral", kernels.banded_matmul_spectral,
             "launches"))


def reset_counts():
    for _, owner, attr in _counters():
        setattr(owner, attr, 0)


def read_counts():
    return {name: getattr(owner, attr) for name, owner, attr in _counters()}


class _Timer:
    """Swaps ``owner.name`` for a wrapper that appends each call's wall
    (device drained at both ends) to ``walls``."""

    def __init__(self, owner, name):
        self.owner, self.name = owner, name
        self.fn = getattr(owner, name)
        self.walls = []

    def __enter__(self):
        import torch

        def wrapped(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return self.fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                self.walls.append(time.perf_counter() - t0)

        setattr(self.owner, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.name, self.fn)


def _session_files(outpath):
    """(files, bytes) that a session write leaves in its folder: the
    products, the parameter file, the instrument and O2 files (not the
    log, masks/ or sources/)."""
    names = [n for n in os.listdir(outpath)
             if os.path.isfile(os.path.join(outpath, n))
             and not n.endswith(".log")]
    return len(names), sum(os.path.getsize(os.path.join(outpath, n))
                           for n in names)


def _product_kinds(outpath, names):
    """The kind of each cube product's file (see PRODUCT_KINDS)."""
    from origin_tpu_torch import fitsio

    out = {}
    for name in names:
        fn = os.path.join(outpath, name + ".fits")
        phdr, dhdr = fitsio.getheader(fn, 0), fitsio.getheader(fn, 1)
        out[name] = (phdr.get("ORITPURE")
                     or ("sparse" if phdr.get("ORITPUSP") else None)
                     or ("int16" if "BSCALE" in dhdr else None)
                     or {8: "uint8", -32: "float32"}[int(dhdr["BITPIX"])])
    return out


class _BeforeWrite:
    """Swaps ``ORIGIN.write`` for a wrapper that keeps, before each write,
    the device tensors of the session's live cube products ``names`` (no
    copy: the references keep them alive)."""

    def __init__(self, cls, names):
        self.cls, self.names = cls, names
        self.fn = cls.write
        self.tensors = {}

    def __enter__(self):
        from origin_tpu_torch.pipeline.products import TensorCube

        def wrapped(orig, *args, **kwargs):
            for name in self.names:
                owner = orig._product_owner[name]
                value = owner.store.peek(name)
                if isinstance(value, TensorCube):
                    self.tensors[name] = value.tensor
            return self.fn(orig, *args, **kwargs)

        self.cls.write = wrapped
        return self

    def __exit__(self, *exc):
        self.cls.write = self.fn


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


def _bound(nbytes, flops, peak_flops):
    """Least time in ms: bytes over the HBM rate or operations over the
    peak rate for their type, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    build.load_libraries(build.KERNELS)
    log(f"build of {', '.join(build.KERNELS)}: "
        f"{time.perf_counter() - t0:.2f} s")
    out = {}
    for name in build.KERNELS:
        info = build.BUILD_INFO[name]
        log(f"  {name}: nvcc {info['seconds']:.2f} s, "
            f"cached={info['cached']}")
        for line in info["ptxas"].splitlines():
            if "Compiling entry" in line:
                log("  ptxas:", line.strip().split("'")[1])
            elif "registers" in line or "spill" in line:
                log("  ptxas:   ", line.strip())
        out[name] = dict(build_s=info["seconds"], cached=info["cached"],
                         ptxas=info["ptxas"])
    return out


# -- phases 3 and b ---------------------------------------------------------
def _banks(dico, nz, dev):
    import torch

    from origin_tpu_torch.core.profiles import (
        default_dictionary_path, load_dictionary)
    from origin_tpu_torch.ops.glr import (
        pack_profiles_toeplitz, prepare_profiles)

    profiles, _ = load_dictionary(default_dictionary_path(dico))
    prepped = prepare_profiles(profiles)
    t_num, t_den, pad_left, _ = pack_profiles_toeplitz(
        prepped, block=min(128, nz))
    return (torch.from_numpy(t_num).to(dev), torch.from_numpy(t_den).to(dev),
            pad_left, prepped)


def _dot64(a, taps, precision):
    """Row sums of ``a * taps`` in float64, of the products the kernel
    forms: float32 operands at ``highest``, the three bf16x3 passes."""
    from origin_tpu_torch.ops.prec import split_bf16

    if precision != "bf16x3":
        return (a.double() * taps.double()).sum(1)
    (ah, al), (th, tl) = split_bf16(a), split_bf16(taps)
    ah, al, th, tl = (v.double() for v in (ah, al, th, tl))
    return (ah * th + al * th + ah * tl).sum(1)


def _t_values(x, n, taps_num, taps_den, pad_left, z, s, k, precision):
    """float64 t_k at voxels (z, s) of (Nz, S) x, n, for profiles k."""
    import torch

    reach = taps_num.shape[1]
    j = torch.arange(reach, device=x.device)
    zi = z[:, None] + j[None, :] - pad_left
    ok = (zi >= 0) & (zi < x.shape[0])
    zi = zi.clamp(0, x.shape[0] - 1)
    xs = torch.where(ok, x[zi, s[:, None]], 0)
    ns = torch.where(ok, n[zi, s[:, None]], 0)
    num = _dot64(xs, taps_num[k], precision)
    den = _dot64(ns, taps_den[k], precision)
    return num / torch.where(den <= 0, float("inf"), den.sqrt())


def _hold_sweep(what, got, ref, x, n, t_num, t_den, pad_left,
                precision="highest"):
    """Check a sweep's (correl, profile, cmin) in the cube's (Nz, ...)
    layout against the plain version's; returns (max abs err, index
    mismatches, largest |t_a - t_b| among them).  The statistics of a
    mismatch are those of ``precision`` (the bf16x3 products in bf16x3),
    so a near-tie is one of the function both sides compute."""
    from origin_tpu_torch.ops.sweep import sweep_taps

    (c, p, m), (cr, pr, mr) = got, ref
    nz = x.shape[0]
    err = max(float((c - cr).abs().max()), float((m - mr).abs().max()))
    close = all(bool(((a - b).abs() <= SWEEP_ATOL + SWEEP_RTOL
                      * b.abs()).all()) for a, b in ((c, cr), (m, mr)))
    check(p.dtype == pr.dtype, f"{what}: profile dtype {p.dtype}")
    check(close, f"{what}: correl/cmin within atol {SWEEP_ATOL} + rtol "
          f"{SWEEP_RTOL} of the plain version (max abs err {err:.3g})")
    bad = (p != pr).reshape(nz, -1).nonzero()
    gap = 0.0
    if bad.numel():
        taps_num, taps_den, _, _ = sweep_taps(t_num, t_den)
        z, s = bad[:, 0], bad[:, 1]
        xf, nf = x.reshape(nz, -1), n.reshape(nz, -1)
        ka = p.reshape(nz, -1)[z, s].long()
        kb = pr.reshape(nz, -1)[z, s].long()
        ta = _t_values(xf, nf, taps_num, taps_den, pad_left, z, s, ka,
                       precision)
        tb = _t_values(xf, nf, taps_num, taps_den, pad_left, z, s, kb,
                       precision)
        gap = float((ta - tb).abs().max())
    check(gap <= TIE_TOL, f"{what}: {bad.shape[0]} profile mismatches, "
          f"all near-ties (max |t_a - t_b| {gap:.3g} <= {TIE_TOL})")
    return err, int(bad.shape[0]), gap


def _sweep_inputs(dev):
    import torch

    g = torch.Generator(device=dev).manual_seed(20261016)
    x = torch.randn(FIELD, generator=g, device=dev)
    n = torch.rand(FIELD, generator=g, device=dev) * 1.5 + 0.5
    return x, n


def _sweep_bound(t_num, t_den, nvox, idx_bytes, peak):
    """Bytes: two float32 inputs and three outputs; operations: two FMAs
    per nonzero tap of every profile per voxel (three passes each in
    bf16x3, on bf16 operands)."""
    from origin_tpu_torch.ops.sweep import sweep_taps

    taps = int(sweep_taps(t_num, t_den)[3].sum())
    passes = 3 if peak == PEAK_BF16 else 1
    return _bound(nvox * (16 + idx_bytes), 2 * 2 * taps * passes * nvox,
                  peak)


def _sweep_values(out):
    """correl and correl_min of a sweep's outputs, stacked."""
    import torch

    return torch.stack((out[0], out[2]))


def _sweep_split(what, got, ref, args):
    """The RMS check that a bf16x3 sweep computes the three passes: its
    distance from the float32 kernel against that kernel's order noise and
    against its own distance from its plain version."""
    from origin_tpu_torch.ops.glr import toeplitz_sweep
    from origin_tpu_torch.ops.sweep import spectral_sweep

    highest = _sweep_values(spectral_sweep(*args))
    noise = _rms(highest - _sweep_values(toeplitz_sweep(*args)))
    got = _sweep_values(got)
    sep = _rms(got - highest)
    err3 = _rms(got - _sweep_values(ref))
    # the float32 kernel and its cuBLAS plain version may agree bit for bit
    # (noise 0); the bf16x3 kernel must still differ from the former
    check(sep > 0 and sep >= SPLIT_SEPARATION * noise,
          f"{what} kernel splits: RMS {sep:.3g} from the highest kernel > 0 "
          f"and >= {SPLIT_SEPARATION:g} x the float32 order noise "
          f"{noise:.3g}")
    check(sep >= SPLIT_NEARER * err3,
          f"{what} kernel splits where its plain version does: RMS "
          f"{err3:.3g} from it, {sep:.3g} from the highest kernel (ratio "
          f"{sep / max(err3, 1e-30):.3g} >= {SPLIT_NEARER:g})")
    return dict(rms_err=err3, rms_from_highest=sep, rms_noise=noise)


def phase_sweep_parity(precision, float32=None):
    """The sweep kernel of ``precision`` against its plain version at K=3
    and K=20, timed; in bf16x3 also the split check and the ratio to the
    float32 kernel's times ``float32`` (phase 3's result)."""
    import torch

    from origin_tpu_torch.core.profiles import DICO_3FWHM, DICO_FWHM_2_12
    from origin_tpu_torch.ops.glr import toeplitz_sweep
    from origin_tpu_torch.ops.sweep import spectral_sweep

    dev = torch.device("cuda")
    nz, ny, nx = FIELD
    x, n = _sweep_inputs(dev)
    out = {}
    for dico in (DICO_3FWHM, DICO_FWHM_2_12):
        t_num, t_den, pad_left, _ = _banks(dico, nz, dev)
        k = t_num.shape[0]
        args = (x, n, t_num, t_den, pad_left, nz)
        got = spectral_sweep(*args, precision=precision)
        torch.cuda.synchronize()
        ref = toeplitz_sweep(*args, precision=precision)
        what = f"{precision} K={k}"
        err, mism, gap = _hold_sweep(what, got, ref, x, n, t_num, t_den,
                                     pad_left, precision)
        row = dict(max_abs_err=err, mismatches=mism, tie_gap=gap)
        if precision == "bf16x3":
            row.update(_sweep_split(what, got, ref, args))
        del got, ref
        ms = _time_cuda(lambda: spectral_sweep(*args, precision=precision),
                        reps=10)
        plain_ms = _time_cuda(lambda: toeplitz_sweep(
            *args, precision=precision), reps=3)
        peak = PEAK_BF16 if precision == "bf16x3" else PEAK_FP32
        bound, by = _sweep_bound(t_num, t_den, x.numel(), 1, peak)
        log(f"  {what}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bound:.3f} ms ({by}) at {nz}x{ny}x{nx}: {bound / ms:.1%} of "
            f"the bound")
        row.update(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by)
        if float32 is not None:
            row["vs_float32"] = ms / float32[k]["ms"]
            log(f"  {what}: {row['vs_float32']:.3f} x the float32 kernel's "
                f"{float32[k]['ms']:.3f} ms (phase 3)")
        out[k] = row
    return out


# -- phases 4, 5 and d --------------------------------------------------------
STEP_NAMES = ("step01", "step02", "step03", "step04", "step05", "step06",
              "step07", "step08", "step09", "step10", "step11")
# phase d's bf16x3 runs stop at Cat1: steps 08-11 run no kernel
FRONT_STEPS = STEP_NAMES[:7]
# the field's step parameters (defaults otherwise); the minicube adds its
# areas and segmap
STEP_KWARGS = dict(step06=dict(purity=0.8), step11=dict(version="0.1"))


def _run_steps(orig, step_kwargs, names=STEP_NAMES, sync=True, peaks=None):
    """Run the steps ``names``; returns their walls (device drained at both
    ends) and, into ``peaks``, the peak device memory after each."""
    import torch

    walls = {}
    for name in names:
        method = next(getattr(orig, m) for m in dir(orig)
                      if m.startswith(name + "_"))
        call = lambda: method(**step_kwargs.get(name, {}))  # noqa: E731
        if sync:
            walls[name] = sync_wall(call)
        else:
            call()
        if peaks is not None:
            peaks[name] = torch.cuda.max_memory_allocated()
    return walls


def _catalog_rows(cat):
    import numpy as np

    cols = ("ID", "x0", "y0", "z0", "comp", "profile")
    return np.stack([np.asarray(cat[c], np.int64) for c in cols], axis=1)


def _rerun_with_plain(orig, step_kwargs, precision, label=None):
    """Steps 05-07 again, with the kernels and then with the plain versions
    in their place (the spatial stage's too in bf16x3), both on the same
    inputs: after step 11's closing write, those that steps 01-04 stored
    in their compact files.  ``label`` names the run in the check (the
    precision by default)."""
    import numpy as np

    from origin_tpu_torch.ops import glr
    from origin_tpu_torch.pipeline import engine

    if orig.steps["save_sources"].status.name != "NOTRUN":
        # step 11's write stored the inputs anew: the kernels' run on them
        _run_steps(orig, step_kwargs, ("step05", "step06", "step07"),
                   sync=False)
    rows, tglr = _catalog_rows(orig.Cat1), np.asarray(orig.Cat1["T_GLR"])
    thr = (orig.param["threshold"], orig.param["threshold_std"])
    kernels = engine.spectral_sweep, engine.spatial_fsf
    engine.spectral_sweep = glr.toeplitz_sweep
    engine.spatial_fsf = glr.glr_spatial_matmul
    try:
        _run_steps(orig, step_kwargs, ("step05", "step06", "step07"),
                   sync=False)
    finally:
        engine.spectral_sweep, engine.spatial_fsf = kernels
    same_rows = (rows.shape == _catalog_rows(orig.Cat1).shape
                 and bool((rows == _catalog_rows(orig.Cat1)).all()))
    plain_t = np.asarray(orig.Cat1["T_GLR"])
    t_ok = same_rows and bool(np.allclose(tglr, plain_t, rtol=1e-4,
                                          equal_nan=True))
    dthr = max(abs(thr[0] - orig.param["threshold"]),
               abs(thr[1] - orig.param["threshold_std"]))
    check(same_rows and t_ok and dthr <= 1e-3,
          f"{label or precision} steps 05-07 with the plain versions: same "
          "Cat1 rows "
          f"and T_GLR (rtol 1e-4), thresholds within {dthr:.2g} <= 1e-3")


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
    if orig.Cat3_sources is not None:
        out.update(cat2=len(orig.Cat2), cat3=_cat3_counts(orig))
        log("  Cat2 %d lines, Cat3 %d lines / %d sources / %d of comp=1"
            % (out["cat2"], *out["cat3"]))
    return out


def _cat3_counts(orig):
    import numpy as np

    comp = np.asarray(orig.Cat3_sources["comp"])
    return (len(orig.Cat3_lines), len(orig.Cat3_sources),
            int((comp == 1).sum()))


def _rel_err(got, want, per_row=False):
    """Largest |got - want| over |want| (over each row's largest |want|
    with ``per_row``, for lines that pass through zero; absolute where
    that is 0, as for a failed line's zeros)."""
    import numpy as np

    got, want = np.asarray(got, float), np.asarray(want, float)
    scale = (np.abs(want).max(axis=-1, keepdims=True) if per_row
             else np.abs(want))
    scale = np.where(scale > 0, scale, 1.0)
    return float((np.abs(got - want) / scale).max()) if want.size else 0.0


def _minicube_lines_checks(orig):
    """Steps 08-09 of the minicube: Cat2 against the JAX package's, row
    for row, and Cat3 against the goldens."""
    import numpy as np

    cat2 = orig.Cat2
    check(len(cat2) == len(GOLD_CAT2["x"]),
          f"minicube Cat2 has {len(cat2)} rows")
    exact = all(np.array_equal(np.asarray(cat2[c], np.int64), GOLD_CAT2[c])
                for c in ("x", "y", "z", "num_line"))
    check(exact, "minicube Cat2 x, y, z and num_line equal the JAX "
          "package's")
    errs = {c: _rel_err(cat2[c], GOLD_CAT2[c]) for c in ("flux", "residual")}
    check(errs["flux"] <= FLUX_RTOL and errs["residual"] <= RESIDUAL_RTOL,
          f"minicube Cat2 flux within rtol {errs['flux']:.3g} <= "
          f"{FLUX_RTOL:g}, residual within {errs['residual']:.3g} <= "
          f"{RESIDUAL_RTOL:g} of the JAX package's")
    counts = _cat3_counts(orig)
    check(counts == GOLD_CAT3, f"minicube Cat3 {counts[0]} lines / "
          f"{counts[1]} sources / {counts[2]} of comp=1 equal the goldens")
    return dict(cat2_rel_err=errs, cat3=counts)


def _field_lines_checks(orig):
    """Step 08 of the field's first Cat1 rows on the card against the
    port's own run on the CPU: x, y, z and ok equal, flux and lines at
    the CPU tests' tolerance."""
    import numpy as np
    import torch

    from origin_tpu_torch.ops.lines import estimation_line_arrays

    cat1 = orig.Cat1[:FIELD_CPU_ROWS]
    pos = [np.asarray(cat1[c], int) for c in ("x0", "y0", "z0")]
    # step 08's parameters are the function's defaults
    card = estimation_line_arrays(*pos, None, None, orig.PSF,
                                  engine=orig.engine)
    t0 = time.perf_counter()
    cpu = estimation_line_arrays(*pos, orig.cube_raw, orig.var, orig.PSF,
                                 device="cpu")
    cpu_s = time.perf_counter() - t0
    n = len(pos[0])
    same = all(np.array_equal(card[k], cpu[k]) for k in ("x", "y", "z",
                                                         "ok"))
    check(same, f"field step 08 of {n} rows on the card: x, y, z and ok "
          f"equal the CPU run's ({cpu_s:.1f} s, {torch.get_num_threads()} "
          "threads)")
    errs = dict(flux=_rel_err(card["flux"], cpu["flux"]),
                line=_rel_err(card["line"], cpu["line"], per_row=True))
    check(errs["flux"] <= FLUX_RTOL and errs["line"] <= LINE_RTOL,
          f"field step 08 on the card: flux within rtol {errs['flux']:.3g} "
          f"<= {FLUX_RTOL:g}, lines within {errs['line']:.3g} <= "
          f"{LINE_RTOL:g} of their largest magnitude, of the CPU run's")
    rows = [np.asarray(orig.Cat2[c])[:n] for c in ("x", "y", "z")]
    ok = card["ok"]
    check(all(np.array_equal(r[ok], card[c][ok])
              for r, c in zip(rows, ("x", "y", "z"))),
          "field Cat2's first rows hold the card's line positions")
    return dict(rows=n, cpu_s=cpu_s, rel_err=errs,
                ok=int(card["ok"].sum()))


def _minicube_source_checks(orig):
    """Steps 10-11 of the minicube against the JAX package's files
    (``GOLD_SOURCES``): the mask triples, REFSPEC and extension counts
    exactly, the two spectra's L2 norms at rtol SOURCE_NORM_RTOL."""
    import numpy as np

    from origin_tpu_torch import fitsio
    from origin_tpu_torch.artifacts import Source
    from origin_tpu_torch.core import Image

    folder = os.path.join(orig.outpath, "sources")
    names = sorted(os.listdir(folder))
    check(names == ["source-%05d.fits" % i for i in sorted(GOLD_SOURCES)],
          f"minicube: {len(names)} source files, the JAX package's")
    triples, heads, worst = [], [], 0.0
    for sid, gold in GOLD_SOURCES.items():
        obj, sky = (Image(os.path.join(orig.outpath, "masks",
                                       f"{kind}-mask-%05d.fits" % sid)).data
                    for kind in ("source", "sky"))
        triples.append((obj.shape[0], int(obj.sum()), int((sky == 1).sum()))
                       == gold[:3])
        fn = os.path.join(folder, "source-%05d.fits" % sid)
        src = Source.from_file(fn)
        ref = src.header["REFSPEC"]
        heads.append((ref, len(fitsio.read(fn)) - 1) == gold[3:5])
        for tag, want in (("MUSE_TOT", gold[5]), (ref, gold[6])):
            got = float(np.linalg.norm(src.spectra[tag].data))
            worst = max(worst, abs(got - want) / want)
    check(all(triples), "minicube: every source's mask edge, object and sky "
          "pixel counts equal the JAX package's")
    check(all(heads), "minicube: every file's REFSPEC and number of "
          "extensions equal the JAX package's")
    check(worst <= SOURCE_NORM_RTOL, f"minicube: MUSE_TOT and REFSPEC L2 "
          f"norms within rtol {worst:.3g} <= {SOURCE_NORM_RTOL:g} of the JAX "
          "package's")
    return dict(files=len(names), norm_rel_err=worst)


class _Recorder:
    """Swaps a module function for a wrapper that keeps each call's
    arguments and result (read after the run, nothing copied during it)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def wrapped(*args):
            out = self.fn(*args)
            self.calls.append((args, out))
            return out

        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def _source_files(orig):
    """(mask files, source files, their bytes) of a session's steps 10-11
    (FITS files only: a problematic_masks.txt is not counted)."""
    counts, nbytes = [], 0
    for sub in ("masks", "sources"):
        folder = os.path.join(orig.outpath, sub)
        names = [n for n in os.listdir(folder) if n.endswith(".fits")]
        counts.append(len(names))
        nbytes += sum(os.path.getsize(os.path.join(folder, n))
                      for n in names)
    return counts[0], counts[1], nbytes


def _rows_rel_err(got, want):
    """Largest |got - want| over each row's largest finite |want|; inf when
    NaN falls in other places."""
    import numpy as np

    got = np.asarray(got, float).reshape(len(got), -1)
    want = np.asarray(want, float).reshape(len(want), -1)
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        return float("inf")
    fin = np.isfinite(want)
    return _rel_err(np.where(fin, got, 0.0), np.where(fin, want, 0.0),
                    per_row=True)


def _field_source_checks(orig, line_calls, spectra_calls, live):
    """Steps 10-11 of the field's cold run against the same functions on
    the CPU: every line max image value for value, the first chunk's
    spectra within SPECTRA_REL, the first files' detection-cube cutouts
    exactly, against the detection cubes ``live`` as they were before the
    closing write stored them in their compact forms."""
    import numpy as np
    import torch

    from origin_tpu_torch.artifacts import Source
    from origin_tpu_torch.core import Cube
    from origin_tpu_torch.ops.cutouts import line_max_images
    from origin_tpu_torch.ops.spectra import source_spectra

    copies = {}

    def host(t):
        """The host copy of a device tensor (one per tensor)."""
        if not torch.is_tensor(t):
            return t
        if t.numel() < 2**20:
            return t.cpu()
        return copies.setdefault(id(t), t.cpu())

    cubes = {0: live["cube_correl"], 1: live["cube_std"]}

    t0 = time.perf_counter()
    same, nimg = True, 0
    for args, (got, _) in line_calls:
        want, _ = line_max_images(host(args[0]), *args[1:])
        same &= np.array_equal(got.cpu().numpy(), want.numpy(),
                               equal_nan=True)
        nimg += len(want)
    lines = orig.Cat3_lines
    need = len(lines) + int((np.asarray(lines["merged_in"]) == -9999).sum())
    check(same and nimg >= need,
          f"field: the {nimg} line max images of steps 10-11 on the card "
          "equal line_max_images on the CPU from the host detection cubes, "
          "value for value")
    nsrc, err = 0, 0.0
    for args, got in spectra_calls:
        if nsrc >= FIELD_CPU_SOURCES:
            break
        want = source_spectra(*(host(a) for a in args))
        err = max([err] + [_rows_rel_err(got[k].cpu().numpy(),
                                         want[k].numpy()) for k in want])
        nsrc += len(args[3])
    check(nsrc >= min(FIELD_CPU_SOURCES, len(orig.Cat3_sources))
          and err <= SPECTRA_REL,
          f"field: the spectra of the first {nsrc} sources on the card "
          f"within {err:.3g} <= {SPECTRA_REL:g} of each row's largest "
          "magnitude of source_spectra on the CPU")
    cat = orig.Cat3_sources
    exact = []
    for row in cat[:FIELD_CUTOUT_FILES]:
        comp = int(row["comp"])
        src = Source.from_file(os.path.join(
            orig.outpath, "sources", "source-%05d.fits" % int(row["ID"])))
        got = src.cubes["ORI_SNCUBE" if comp else "ORI_CORREL"].data
        parent = Cube(data=host(cubes[comp]).numpy(), wcs=orig.wcs,
                      wave=orig.wave, copy=False)
        sub = parent.subcube((float(row["dec"]), float(row["ra"])),
                             got.shape[1], unit_center="deg")
        exact.append(np.array_equal(
            got, np.where(sub.mask, np.nan, sub.data), equal_nan=True))
    check(all(exact), f"field: the detection-cube cutouts of the first "
          f"{len(exact)} source files equal the host cube's subcube, NaN "
          "outside the field included")
    return dict(line_images=nimg, spectra_sources=nsrc, spectra_rel_err=err,
                cutout_files=len(exact),
                cpu_s=time.perf_counter() - t0)


def _path_kernels(precision):
    """The kernels that steps 01-07 launch at this precision."""
    if precision == "bf16x3":
        return ("spatial_fsf", "toeplitz_sweep_bf16x3")
    return ("toeplitz_sweep",)


def _minicube_files():
    from tools_torch.synthetic import make_minicube, make_segmap

    cube_fn = os.path.join(WORK, "minicube.fits")
    seg_fn = os.path.join(WORK, "segmap.fits")
    make_minicube(cube_fn)
    make_segmap(seg_fn)
    return cube_fn, seg_fn


def phase_minicube(precision="highest", names=STEP_NAMES):
    from origin_tpu_torch import native
    from origin_tpu_torch.pipeline.session import ORIGIN
    from tools_torch.synthetic import BRIGHT_LINES, FAINT_LINES

    cube_fn, seg_fn = _minicube_files()
    kwargs = dict(STEP_KWARGS, step02=dict(minsize=30, maxsize=60),
                  step07=dict(segmap=seg_fn))
    reset_counts()
    orig = ORIGIN.init(cube_fn, name=f"minicube_{precision}", path=WORK,
                       loglevel="WARNING", device="cuda")
    walls = _run_steps(orig, kwargs, names)
    counts = read_counts()
    log("  walls: " + " ".join(f"{k} {v:.2f}s" for k, v in walls.items()))
    log(f"  launches in this run: {counts}")
    out = _summary(orig, GOLD_MINI)
    out["launches"] = counts
    for name in _path_kernels(precision):
        check(counts[name] > 0, f"the minicube run launched {name} "
              f"({counts[name]} launches)")
    out["fof"] = ("native C++ (g++)" if native.get_lib() is not None
                  else "Python fallback")
    log(f"  step 07 friends-of-friends: {out['fof']}")
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
    if "step09" in names:
        out["lines"] = _minicube_lines_checks(orig)
    if "step11" in names:
        out["sources"] = _minicube_source_checks(orig)
    _rerun_with_plain(orig, kwargs, precision)
    orig.close_logfile()
    shutil.rmtree(orig.outpath, ignore_errors=True)
    out["walls"] = walls
    return out


def _field_checks(got, orig, lines):
    bright = [(x, y, z) for x, y, z, kind in lines if kind == "bright"]
    faint = [(x, y, z) for x, y, z, kind in lines if kind == "faint"]
    gb, nb = _recovered(orig.Cat1, bright)
    gf, nf = _recovered(orig.Cat1, faint)
    log(f"  injected lines recovered: bright {gb}/{nb}, faint {gf}/{nf}")
    got.update(bright=[gb, nb], faint=[gf, nf])
    check(abs(got["threshold_std"] - GOLD_FIELD["threshold_std"])
          <= THRESH_TOL, f"field std threshold within {THRESH_TOL} of JAX")
    check(abs(got["threshold"] - ORACLE_FIELD["threshold"]) <= THRESH_TOL,
          f"field correl threshold within {THRESH_TOL} of the step-04 "
          f"oracle's {ORACLE_FIELD['threshold']} (JAX's early-stopped "
          f"{GOLD_FIELD['threshold']})")
    for key in ("cat0", "cat1"):
        check(abs(got[key] - ORACLE_FIELD[key]) <= COUNT_TOL,
              f"field {key} {got[key]} within {COUNT_TOL} line of the "
              f"step-04 oracle's {ORACLE_FIELD[key]} (JAX's early-stopped "
              f"{GOLD_FIELD[key]})")
    check(gb == nb, "field: every bright injected line in Cat1")


def phase_field(field, precision="highest", names=STEP_NAMES):
    """Steps ``names`` of the field file, cold then warm; the counters are
    set to 0 just before the cold run and read just after it.  Returns the
    runs, the cold run's launches and, for phase e, its thresholds,
    catalogs and file counts before the plain re-run."""
    import torch

    from origin_tpu_torch.artifacts import masks
    from origin_tpu_torch.ops import spectra
    from origin_tpu_torch.pipeline.session import ORIGIN

    field_fn, lines = field
    out, ref = {}, None
    runs = ("cold", "warm")
    sources = "step11" in names
    for run in runs:
        gc.collect()  # the session <-> engine cycle holds the last run's cubes
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        first = run == runs[0]
        if first:
            reset_counts()
        orig = ORIGIN.init(field_fn, name=f"field_{precision}_{run}",
                           path=WORK, loglevel="WARNING", device="cuda")
        if first:
            check(_reader(orig) == "streamed", f"the {precision} field "
                  "session took the streamed ingest")
        peaks = {}
        with _Recorder(masks, "line_max_images") as line_calls, \
                _Recorder(spectra, "source_spectra") as spectra_calls, \
                _Timer(ORIGIN, "write") as writes, \
                _BeforeWrite(ORIGIN, ("cube_correl", "cube_std",
                                      "cube_local_min") + PINNED) as live:
            walls = _run_steps(orig, STEP_KWARGS, names, peaks=peaks)
        if first:
            counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        log(f"  {run}: " + " ".join(f"{k} {v:.3f}s" for k, v in walls.items())
            + f"  total {sum(walls.values()):.3f}s  peak {peak / 2**30:.2f}"
            " GiB")
        out[run] = dict(walls=walls, total=sum(walls.values()),
                        peak_bytes=peak, **_summary(orig, GOLD_FIELD))
        if sources:
            nmask, nsrc, nbytes = _source_files(orig)
            p09 = peaks["step09"]
            log(f"  {run}: steps 01-09 {sum(walls[k] for k in names[:9]):.3f}"
                f" s, steps 10-11 {walls['step10'] + walls['step11']:.3f} s;"
                f" {nsrc} source files and {nmask} mask files, {nbytes} "
                f"bytes; peak through step 09 {p09 / 2**30:.3f} GiB")
            check(len(writes.walls) == 1, f"field {run}: step 11 ended in "
                  "one session write")
            wfiles, wbytes = _session_files(orig.outpath)
            wall = writes.walls[0]
            kinds = _product_kinds(orig.outpath, PRODUCT_KINDS)
            log(f"  {run}: step 11 {walls['step11']:.3f} s with its session "
                f"write {wall:.3f} s ({walls['step11'] - wall:.3f} s "
                f"without); the write: {wfiles} files, {wbytes} bytes, "
                f"{wbytes / wall / 1e9:.3f} GB/s (dense: "
                f"{DENSE_WRITE}); product files: "
                + ", ".join(f"{k} {v}" for k, v in kinds.items()))
            check(kinds == PRODUCT_KINDS, f"field {run}: the closing write "
                  "stored the ten cube products in the JAX package's "
                  "default kinds (3 recipes, 4 sparse, 2 int16, 1 uint8)")
            out[run].update(mask_files=nmask, source_files=nsrc,
                            source_bytes=nbytes, peak_step09_bytes=p09,
                            write_s=wall, write_files=wfiles,
                            write_bytes=wbytes, product_kinds=kinds)
            check(nsrc == len(orig.Cat3_sources) and nmask == 2 * nsrc,
                  f"field {run}: one source file and two mask files for "
                  f"each of the {len(orig.Cat3_sources)} Cat3 sources")
            check(peak <= PEAK_GROWTH * p09, f"field {run}: steps 10-11 keep "
                  f"the peak within {PEAK_GROWTH:g} x steps 01-09's "
                  f"({peak / p09:.4f})")
        if first:
            log(f"  launches in this run: {counts}")
            out[run]["launches"] = counts
            for name in _path_kernels(precision):
                check(counts[name] > 0, f"the {precision} field run launched "
                      f"{name} ({counts[name]} launches)")
            _field_checks(out[run], orig, lines)
            if sources:
                # phase i's single-device reference: the live cubes on
                # the host, so that no later phase's peak holds them
                ref = dict(threshold=orig.param["threshold"],
                           threshold_std=orig.param["threshold_std"],
                           files=(nmask, nsrc),
                           mapO2=orig.mapO2.data.copy(),
                           maxmap=orig.maxmap.data.copy(),
                           pinned={n: live.tensors[n].cpu().numpy()
                                   for n in ("cube_correl", "cube_local_min")
                                   + PINNED},
                           # phase k's inputs: step 05's FSF, step 06's
                           # segmap and purity table
                           psf=orig.PSF, wfields=orig.wfields,
                           segmap_purity=orig.segmap_purity.data.copy(),
                           Pval=orig.Pval,
                           **{n: getattr(orig, n) for n in CATALOGS})
            if "step08" in names:
                out[run]["lines"] = _field_lines_checks(orig)
            if sources:
                out[run]["sources"] = _field_source_checks(
                    orig, line_calls.calls, spectra_calls.calls,
                    live.tensors)
            _rerun_with_plain(orig, STEP_KWARGS, precision)
        orig.close_logfile()
        shutil.rmtree(orig.outpath, ignore_errors=True)
        del orig
    return out, counts, ref


# -- phase e ------------------------------------------------------------------
def _same_rows(got, want, rtol):
    """Row for row: every integer column exact, every float column at
    ``rtol`` (NaN where the other is NaN)."""
    import numpy as np

    if got.colnames != want.colnames or len(got) != len(want):
        return False
    for col in want.colnames:
        a, b = np.asarray(got[col]), np.asarray(want[col])
        if b.dtype.kind == "f":
            if not np.allclose(a, b, rtol=rtol, atol=0, equal_nan=True):
                return False
        elif not np.array_equal(a, b):
            return False
    return True


def _first_fetches(orig, names):
    """Each product's first fetch after its park: (FITS read s, host
    rebuild s, upload s), one product at a time, the device drained at both
    ends.  The read is the dense or compact file's, or the recipe's; the
    rebuild a recipe's on the host (0 for any other file), with the raw
    cube's host views or cube_std's host copy that it needs; the upload
    the rest of the fetch."""
    from origin_tpu_torch.pipeline import products, recipes, steps

    acc = {"read": 0.0, "rebuild": 0.0}

    def timed(fn, key):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                acc[key] += time.perf_counter() - t0
        return wrapped

    fmt = products.FORMATS["cube"]
    swaps = [(steps, "load_recipe", "read"),
             (recipes.LazyRecipeCube, "_rebuild_full", "rebuild")]
    kept = [getattr(mod, attr) for mod, attr, _ in swaps]
    products.FORMATS["cube"] = fmt._replace(load=timed(fmt.load, "read"))
    for (mod, attr, key), fn in zip(swaps, kept):
        setattr(mod, attr, timed(fn, key))
    out = {}
    try:
        for name in names:
            acc.update(read=0.0, rebuild=0.0)
            wall = sync_wall(lambda: getattr(orig, name))
            out[name] = (acc["read"], acc["rebuild"],
                         wall - acc["read"] - acc["rebuild"])
    finally:
        products.FORMATS["cube"] = fmt
        for (mod, attr, _), fn in zip(swaps, kept):
            setattr(mod, attr, fn)
    return out


def _fetch_line(fetch):
    return ", ".join(f"{k} {r:.3f}/{b:.3f}/{u:.3f}"
                     for k, (r, b, u) in fetch.items())


def phase_resume(field, ref):
    """Session B: steps 01-04 of the field file, then write(); session C:
    load(device="cuda"), steps 05-11 with the counters set to 0 just
    before, held against phase 5's cold run."""
    import torch

    from origin_tpu_torch.pipeline.products import Parked
    from origin_tpu_torch.pipeline.session import ORIGIN

    field_fn, _ = field
    gc.collect()
    torch.cuda.empty_cache()
    b = ORIGIN.init(field_fn, name="resume", path=WORK, loglevel="WARNING",
                    device="cuda")
    walls_b = _run_steps(b, STEP_KWARGS, STEP_NAMES[:4])
    # B writes dense files, so that C resumes from B's bits exactly; C's
    # own closing write takes the default compact forms
    saved = {k: os.environ.get(k) for k in STORE_KNOBS}
    os.environ.update(dict.fromkeys(STORE_KNOBS, "0"))
    try:
        write_s = sync_wall(b.write)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    folder = b.outpath
    files, nbytes = _session_files(folder)
    kinds = _product_kinds(folder, ("cube_std", "cube_faint",
                                    "cube_std_local_max"))
    check(set(kinds.values()) == {"float32"}, "B wrote dense float32 files "
          f"with the store knobs at 0 ({kinds})")
    b.close_logfile()
    del b
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  B: steps 01-04 {sum(walls_b.values()):.3f} s; write "
        f"{write_s:.3f} s ({files} files, {nbytes} bytes, "
        f"{nbytes / write_s / 1e9:.3f} GB/s)")

    t0 = time.perf_counter()
    c = ORIGIN.load(folder, device="cuda")
    load_s = time.perf_counter() - t0
    check(c.engine.device.type == "cuda" and isinstance(
        c.steps["compute_greedy_PCA"].store.peek("cube_faint"), Parked),
        "C loaded on cuda with cube_faint parked in B's file")
    fetch = _first_fetches(c, ("cube_faint",))
    reset_counts()
    walls_c = _run_steps(c, STEP_KWARGS, STEP_NAMES[4:])
    counts = read_counts()
    log(f"  C: load {load_s:.3f} s; steps 05-11 "
        + " ".join(f"{k} {v:.3f}s" for k, v in walls_c.items())
        + f"  total {sum(walls_c.values()):.3f}s")
    log(f"  launches in C's steps 05-11: {counts}")
    check(counts["toeplitz_sweep"] > 0, "C's step 05 launched toeplitz_sweep "
          f"({counts['toeplitz_sweep']} launches) on the cube_faint read "
          "back from B's file")
    check(c.param["threshold"] == ref["threshold"]
          and c.param["threshold_std"] == ref["threshold_std"],
          f"C's thresholds {c.param['threshold']:.6f} / "
          f"{c.param['threshold_std']:.6f} equal the uninterrupted run's")
    for name in CATALOGS:
        got, want = getattr(c, name), ref[name]
        check(_same_rows(got, want, RESUME_RTOL), f"C's {name} ({len(got)} "
              "rows) equals the uninterrupted run's row for row (integers "
              f"exact, floats at rtol {RESUME_RTOL:g})")
    nmask, nsrc, _ = _source_files(c)
    check((nmask, nsrc) == ref["files"], f"C wrote {nsrc} source and "
          f"{nmask} mask files, as the uninterrupted run")
    fetch.update(_first_fetches(c, STEP05_CUBES))
    log("  first fetches (FITS read / rebuild / upload s; cube_faint's "
        "dense, the others from C's compact write): " + _fetch_line(fetch))
    c.close_logfile()
    shutil.rmtree(folder, ignore_errors=True)
    return dict(walls_b=walls_b, write_s=write_s, write_files=files,
                write_bytes=nbytes, load_s=load_s, walls_c=walls_c,
                launches=counts, first_fetch_s=fetch)


# -- phase f ------------------------------------------------------------------
def _hold_compact(name, got, live, kind, scale, pairs=None):
    """A product read back from its compact file (``got``, decoded on the
    device, its kept ``scale``; ``pairs`` the sparse file's own) against
    the live tensor it was written from: the file's integers and scale are
    the encoder's of the live tensor bit for bit, and each decoded value
    lies within half a step of the live one, but the extrema that the
    sparse form clamps to +-1 step."""
    import numpy as np
    import torch

    from origin_tpu_torch.ops.quant import encode_i16, sparse_i16

    if kind == "int16":
        q, s = encode_i16(live)
        decoded = q.to(torch.float32) * torch.tensor(np.float32(s),
                                                     device=q.device)
        same = s == scale and torch.equal(got, decoded)
        clamped = torch.zeros_like(live, dtype=torch.bool)
    else:
        idx, q, s = sparse_i16(live)
        same = (s == scale and np.array_equal(pairs[0], idx.cpu().numpy())
                and np.array_equal(pairs[1], q.cpu().numpy()))
        clamped = (live != 0) & (live.abs() < 0.5 * np.float32(s))
    err = (got.double() - live.double()).abs()
    err = torch.where(clamped, 0.0, err).max().item() / s
    check(same and err <= HALF_STEP_TOL, f"C2: {name} ({kind}) holds the "
          f"encoder's integers and scale of its live tensor bit for bit, "
          f"decoded within {err:.4f} <= {HALF_STEP_TOL} step "
          f"({int(clamped.sum())} extrema clamped to one step)")
    return dict(max_err_steps=err, scale=s, clamped=int(clamped.sum()))


def phase_compact(field, ref):
    """Session B2: steps 01-04 of the field file, written in the default
    compact files; C2: load(device="cuda"), the first fetches of the recipe
    products, steps 05-11 with the counters set to 0 just before, held
    against phase 5's cold run; C2's closing write read back as D and held
    against the live tensors it was written from."""
    import numpy as np
    import torch

    from origin_tpu_torch.core import Cube
    from origin_tpu_torch.pipeline.session import ORIGIN

    field_fn, _ = field
    gc.collect()
    torch.cuda.empty_cache()
    b = ORIGIN.init(field_fn, name="compact", path=WORK, loglevel="WARNING",
                    device="cuda")
    walls_b = _run_steps(b, STEP_KWARGS, STEP_NAMES[:4])
    faint = b.cube_faint.tensor.cpu().numpy()  # before B2 is freed
    write_s = sync_wall(b.write)
    folder = b.outpath
    files, nbytes = _session_files(folder)
    front = ("cube_std", "cont_dct", "cube_faint", "cube_std_local_min",
             "cube_std_local_max")
    kinds = _product_kinds(folder, front)
    b.close_logfile()
    del b
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  B2: steps 01-04 {sum(walls_b.values()):.3f} s; write "
        f"{write_s:.3f} s ({files} files, {nbytes} bytes; "
        + ", ".join(f"{k} {v}" for k, v in kinds.items()) + ")")
    check(kinds == {k: PRODUCT_KINDS[k] for k in front},
          "B2 wrote three recipes and two sparse tables")

    t0 = time.perf_counter()
    c = ORIGIN.load(folder, device="cuda")
    load_s = time.perf_counter() - t0
    fetch = _first_fetches(c, ("cube_std", "cube_faint"))
    dfaint = float(np.abs(c.cube_faint.tensor.cpu().numpy() - faint).max())
    del faint
    log(f"  C2: load {load_s:.3f} s; first fetches (FITS read / host "
        f"rebuild / upload s): {_fetch_line(fetch)}; the rebuilt cube_faint "
        f"within {dfaint:.3g} of B2's live tensor")
    check(dfaint <= 1e-3, f"C2's cube_faint rebuilt from its recipe within "
          f"{dfaint:.3g} <= 1e-3 of B2's live tensor")
    compact = tuple(n for n in STEP05_CUBES if PRODUCT_KINDS[n] != "uint8")
    reset_counts()
    with _Timer(ORIGIN, "write") as writes, \
            _BeforeWrite(ORIGIN, compact) as live:
        walls_c = _run_steps(c, STEP_KWARGS, STEP_NAMES[4:])
    counts = read_counts()
    log(f"  C2: steps 05-11 " + " ".join(f"{k} {v:.3f}s"
                                         for k, v in walls_c.items())
        + f"  total {sum(walls_c.values()):.3f}s; its write "
        f"{writes.walls[0]:.3f} s")
    log(f"  launches in C2's steps 05-11: {counts}")
    check(counts["toeplitz_sweep"] > 0, "C2's step 05 launched "
          f"toeplitz_sweep ({counts['toeplitz_sweep']} launches) on the "
          "cube_faint rebuilt from its recipe")
    dthr = c.param["threshold"] - ref["threshold"]
    check(abs(dthr) <= 1e-3, f"C2's correl threshold "
          f"{c.param['threshold']:.6f} within {dthr:+.3g} (<= 1e-3) of the "
          "uninterrupted run's")
    for name in ("Cat0", "Cat1"):
        got, want = len(getattr(c, name)), len(ref[name])
        check(abs(got - want) <= COUNT_TOL, f"C2's {name} {got} within "
              f"{COUNT_TOL} line of the uninterrupted run's {want}")
    kinds = _product_kinds(folder, PRODUCT_KINDS)
    check(kinds == PRODUCT_KINDS, "C2's closing write left the ten default "
          "kinds (3 recipes, 4 sparse, 2 int16, 1 uint8)")
    check(set(live.tensors) == set(compact), "C2's closing write stored "
          f"{sorted(live.tensors)}")
    summary = dict(threshold=c.param["threshold"],
                   threshold_std=c.param["threshold_std"],
                   cat0=len(c.Cat0), cat1=len(c.Cat1),
                   write_c_s=writes.walls[0])
    c.close_logfile()
    del c
    gc.collect()
    torch.cuda.empty_cache()

    d = ORIGIN.load(folder, device="cuda")
    held = {}
    for name, tensor in live.tensors.items():
        cube = getattr(d, name)
        pairs = None
        if PRODUCT_KINDS[name] == "sparse":
            pairs = Cube(os.path.join(folder, name + ".fits"))._wire16.pairs
        held[name] = _hold_compact(name, cube.tensor, tensor,
                                   PRODUCT_KINDS[name], cube.scale, pairs)
    d.close_logfile()
    del d, live
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(folder, ignore_errors=True)
    return dict(walls_b=walls_b, write_s=write_s, write_files=files,
                write_bytes=nbytes, load_s=load_s, first_fetch_s=fetch,
                faint_max_abs=dfaint, walls_c=walls_c, launches=counts,
                held=held, **summary)


# -- phase g ------------------------------------------------------------------
def _cli(argv):
    """``python -m origin_tpu_torch`` in this process: (rc, stdout, wall
    with the device drained at both ends)."""
    import contextlib
    import io

    import torch

    from origin_tpu_torch.__main__ import main as cli_main

    buf = io.StringIO()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    return rc, buf.getvalue(), time.perf_counter() - t0


def _dense_cube_file(path):
    """The data of a dense cube file, or None for a recipe, sparse or
    scaled-int16 one."""
    from origin_tpu_torch import fitsio

    phdr, dhdr = fitsio.getheader(path, 0), fitsio.getheader(path, 1)
    if phdr.get("ORITPURE") or phdr.get("ORITPUSP") or "BSCALE" in dhdr:
        return None
    return fitsio.getdata(path)


def _close_to_max(a, b, rel):
    """|a - b| over b's largest finite magnitude (inf where the NaNs
    differ)."""
    import numpy as np

    a, b = np.asarray(a, float), np.asarray(b, float)
    if a.shape != b.shape or not np.array_equal(np.isnan(a), np.isnan(b)):
        return float("inf")
    fin = np.isfinite(b)
    scale = np.abs(b[fin]).max() if fin.any() else 1.0
    return float(np.abs(a[fin] - b[fin]).max() / scale) if fin.any() else 0.0


def _source_file_errors(got, want):
    """Each extension of a refreshed source file against step 11's, by the
    rules of tests/test_torch_pipeline.py (``assert_same_source_files``):
    per rule, the largest error over its limit; any value above 1 fails."""
    import numpy as np

    worst = {}

    def note(rule, err, limit):
        worst[rule] = max(worst.get(rule, 0.0), err / limit)

    for kind in ("cubes", "images", "spectra", "tables"):
        if set(getattr(got, kind)) != set(getattr(want, kind)):
            note("extensions", float("inf"), 1.0)
            return worst
    for key, cb in want.cubes.items():
        ca = got.cubes[key]
        if key == "MUSE_CUBE":
            same = all(np.array_equal(getattr(ca, a), getattr(cb, a),
                                      equal_nan=True) for a in ("data", "var"))
            note("exact", 0.0 if same else float("inf"), 1.0)
        else:  # ORI_CORREL / ORI_SNCUBE
            note("detection cubes atol 1e-3", float(np.nanmax(np.abs(
                np.asarray(ca.data, float) - np.asarray(cb.data, float)))),
                 1e-3)
    for key, ib in want.images.items():
        ia = got.images[key]
        if key.startswith("ORI_CORR_") or key == "ORI_MAXMAP":
            note("detection cubes atol 1e-3", float(np.nanmax(np.abs(
                np.asarray(ia.data, float) - np.asarray(ib.data, float)))),
                 1e-3)
        elif key == "MUSE_WHITE":
            note("MUSE 1e-5 of max", _close_to_max(ia.data, ib.data, 1e-5),
                 1e-5)
        else:
            note("exact", 0.0 if np.array_equal(ia.data, ib.data)
                 else float("inf"), 1.0)
    for key, sb in want.spectra.items():
        sa = got.spectra[key]
        for arr in ("data", "var"):
            x, y = getattr(sa, arr), getattr(sb, arr)
            if (x is None) != (y is None):
                note("exact", float("inf"), 1.0)
            if y is None:
                continue
            if key.startswith("MUSE_"):
                note("MUSE 1e-5 of max", _close_to_max(x, y, 1e-5), 1e-5)
            elif key.startswith("ORI_SPEC_"):
                note("ORI_SPEC 1e-4 of max", _close_to_max(x, y, 1e-4), 1e-4)
            else:
                scale = max(1.0, float(np.nanmax(np.abs(y))))
                note("ORI_CORR atol 2e-3", float(np.nanmax(np.abs(
                    np.asarray(x, float) - np.asarray(y, float)))) / scale,
                     2e-3)
    tables = dict(LINES=(got.lines, want.lines),
                  **{k: (got.tables[k], want.tables[k])
                     for k in ("ORI_LINES", "ORI_CAT", "NB_PAR")})
    for key, (ta, tb) in tables.items():
        if ta.colnames != tb.colnames:
            note("exact", float("inf"), 1.0)
            continue
        for col in tb.colnames:
            x, y = np.asarray(ta[col]), np.asarray(tb[col])
            if y.dtype.kind == "f":
                ok = np.allclose(x, y, rtol=1e-4, atol=0, equal_nan=True)
                note("tables rtol 1e-4", 0.0 if ok else float("inf"), 1.0)
            else:
                note("exact", 0.0 if np.array_equal(x, y)
                     else float("inf"), 1.0)
    return worst


def phase_surface(field, ref):
    """The session's user surface on the card: the CLI's field run (held to
    phase 5's cold run bit for bit), its status and info, a reference
    export of a live session after step 04 resumed on the card, a
    reference export of the CLI's compact session (each dense cube file
    held to the loaded session's fetch), and the catalog edits, masks and
    source files refreshed on the loaded session."""
    import numpy as np
    import torch

    from origin_tpu_torch.artifacts import (
        Source, merge_sources, split_source, update_masks, update_sources,
    )
    from origin_tpu_torch.core import Image, Table
    from origin_tpu_torch.pipeline.products import TensorCube
    from origin_tpu_torch.pipeline.session import ORIGIN
    from origin_tpu_torch.pipeline.steps import Status

    field_fn, _ = field
    t_phase = time.perf_counter()
    out = {}
    exports = os.path.join(WORK, "exports")
    shutil.rmtree(exports, ignore_errors=True)
    os.makedirs(exports)

    # 1. the CLI's run of the field, as phase 5 runs it
    gc.collect()
    torch.cuda.empty_cache()
    reset_counts()
    rc, _, cli_s = _cli(["run", field_fn, "--device", "cuda", "--purity",
                         "0.8", "--name", "cli", "--path", WORK,
                         "--loglevel", "WARNING"])
    counts = read_counts()
    folder = os.path.join(WORK, "cli")
    check(rc == 0, f"CLI run of the field: rc {rc}, {cli_s:.3f} s")
    log(f"  launches in the CLI run: {counts}")
    check(counts["toeplitz_sweep"] > 0, "the CLI run launched toeplitz_sweep "
          f"({counts['toeplitz_sweep']} launches)")
    cats = {n: Table.read(os.path.join(folder, n + ".fits"))
            for n in ("Cat0", "Cat1", "Cat3_lines", "Cat3_sources")}
    for name, cat in cats.items():
        check(_same_rows(cat, ref[name], 0.0), f"the CLI's {name} "
              f"({len(cat)} rows) equals phase 5's cold run bit for bit")
    out.update(cli_s=cli_s, launches=counts,
               counts={n: len(c) for n, c in cats.items()})

    # 2. status and info
    rc_s, status, _ = _cli(["status", folder])
    rc_i, info, _ = _cli(["info", folder])
    steps = [ln for ln in status.splitlines() if ln.startswith("- ")]
    check(rc_s == 0 and len(steps) == 11
          and all(ln.endswith(": DUMPED") for ln in steps),
          "CLI status: rc 0, the 11 steps DUMPED")
    check(rc_i == 0 and "Step 11 - Save sources" in info
          and "finished" not in info, f"CLI info: rc 0, {len(info)} "
          "characters of log without the completion lines")

    # 3. a live session after step 04, exported in the reference dialect
    # and resumed on the card
    b = ORIGIN.init(field_fn, name="live", path=WORK, loglevel="WARNING",
                    device="cuda")
    _run_steps(b, STEP_KWARGS, STEP_NAMES[:4])
    live_dir = os.path.join(exports, "live")
    os.makedirs(live_dir)
    export = []
    export_s = sync_wall(lambda: export.append(
        b.write(path=live_dir, compat="reference")))
    files, nbytes = _session_files(export[0])
    b.close_logfile()
    shutil.rmtree(b.outpath, ignore_errors=True)
    del b
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    c = ORIGIN.load(export[0], device="cuda")
    load_s = time.perf_counter() - t0
    log(f"  live export after step 04: {export_s:.3f} s, {files} files, "
        f"{nbytes} bytes, {nbytes / export_s / 1e9:.3f} GB/s; load "
        f"{load_s:.3f} s")
    check([s.status for s in c.steps.values()][:5]
          == [Status.DUMPED] * 4 + [Status.NOTRUN],
          "the loaded export has steps 01-04 DUMPED")
    reset_counts()
    walls_c = _run_steps(c, STEP_KWARGS, STEP_NAMES[4:])
    counts_c = read_counts()
    log("  steps 05-11 of the loaded export: " + " ".join(
        f"{k} {v:.3f}s" for k, v in walls_c.items())
        + f"  total {sum(walls_c.values()):.3f}s; launches {counts_c}")
    check(counts_c["toeplitz_sweep"] > 0, "step 05 of the loaded export "
          f"launched toeplitz_sweep ({counts_c['toeplitz_sweep']} "
          "launches) on the exported cube_faint")
    check(c.param["threshold"] == ref["threshold"]
          and c.param["threshold_std"] == ref["threshold_std"],
          f"the loaded export's thresholds {c.param['threshold']:.6f} / "
          f"{c.param['threshold_std']:.6f} equal the uninterrupted run's")
    for name in CATALOGS:
        got, want = getattr(c, name), ref[name]
        check(_same_rows(got, want, RESUME_RTOL), f"the loaded export's "
              f"{name} ({len(got)} rows) equals the uninterrupted run's "
              f"row for row (integers exact, floats at rtol {RESUME_RTOL:g})")
    check(_source_files(c)[:2] == ref["files"], "the loaded export wrote "
          "as many mask and source files as the uninterrupted run")
    c.close_logfile()
    del c
    shutil.rmtree(live_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    out.update(live_export_s=export_s, live_export_files=files,
               live_export_bytes=nbytes, live_load_s=load_s,
               live_walls_c=walls_c, live_launches=counts_c)

    # 4. the CLI's compact session loaded and exported
    t0 = time.perf_counter()
    d = ORIGIN.load(folder, device="cuda")
    load_d = time.perf_counter() - t0
    log("  the CLI run's steps (timestat): " + "; ".join(
        f"{r['Step']} {r['Exec Time']}" for r in d.timestat(table=True)))
    kinds = _product_kinds(folder, PRODUCT_KINDS)
    check(kinds == PRODUCT_KINDS, "the CLI's session holds the ten default "
          "kinds (3 recipes, 4 sparse, 2 int16, 1 uint8)")
    fetch = _first_fetches(d, tuple(PRODUCT_KINDS))
    compact_dir = os.path.join(exports, "compact")
    os.makedirs(compact_dir)
    export = []
    write_s = sync_wall(lambda: export.append(
        d.write(path=compact_dir, compat="reference")))
    files, nbytes = _session_files(export[0])
    fetch_s = sum(sum(v) for v in fetch.values())
    log(f"  compact export: load {load_d:.3f} s; first fetches "
        f"{fetch_s:.3f} s ({_fetch_line(fetch)}); the export after them "
        f"{write_s:.3f} s ({files} files, {nbytes} bytes, "
        f"{nbytes / write_s / 1e9:.3f} GB/s); total {fetch_s + write_s:.3f}"
        " s")
    same = {}
    for name in PRODUCT_KINDS:
        got = _dense_cube_file(os.path.join(export[0], name + ".fits"))
        want = getattr(d, name).tensor.cpu().numpy()
        same[name] = (got is not None and got.dtype == want.dtype
                      and np.array_equal(got, want, equal_nan=True))
    check(all(same.values()), "each dense cube file of the compact export "
          f"equals the loaded session's fetch bit for bit ({same})")
    shutil.rmtree(export[0], ignore_errors=True)
    out.update(compact_load_s=load_d, compact_fetch_s=fetch,
               compact_export_s=write_s, compact_export_files=files,
               compact_export_bytes=nbytes)

    # 5. the catalog edits and the refreshed masks and source files
    lines, sources = d.Cat3_lines, d.Cat3_sources
    ids, nlines = np.unique(np.asarray(lines["ID"]), return_counts=True)
    sid = int(ids[nlines >= 2][0])
    edit_l, edit_s = lines.copy(), sources.copy()
    nums = np.asarray(edit_l["num_line"])[np.asarray(edit_l["ID"]) == sid]
    new_id = split_source(sid, [int(nums[0])], edit_s, edit_l)
    split_rows = len(edit_s)
    merged = merge_sources(sid, [new_id], edit_s, edit_l)
    check(new_id is not None and split_rows == len(sources) + 1 and merged
          and _same_rows(edit_l, lines, 0.0)
          and _same_rows(edit_s, sources, 0.0),
          f"source {sid} ({len(nums)} lines) split into {sid} and {new_id} "
          "and merged back: the Cat3 tables equal the originals")
    chosen = [int(i) for i in sources["ID"][:3]]
    masks_dir = os.path.join(exports, "masks")
    os.makedirs(masks_dir)
    check(isinstance(d.cube_correl, TensorCube)
          and d.cube_correl.tensor.is_cuda, "update_masks takes the "
          "session's resident cube_correl on the card")
    masks_s = sync_wall(lambda: update_masks(
        chosen, lines, sources, d.FWHM_profiles, d.cube_correl,
        d.threshold_correl, d.cube_std, d.threshold_std, d.segmap_label,
        d.LBDA_FWHM_PSF, masks_dir, plot_problems=False))
    equal = []
    for i in chosen:
        for kind in ("source", "sky"):
            name = f"{kind}-mask-%05d.fits" % i
            a = Image(os.path.join(masks_dir, name))
            b = Image(os.path.join(folder, "masks", name))
            equal.append(np.array_equal(a.data, b.data)
                         and tuple(a.wcs.crpix) == tuple(b.wcs.crpix))
    check(all(equal) and len(equal) == 6, f"update_masks of sources "
          f"{chosen} on the card ({masks_s:.3f} s): the masks equal step "
          "10's files exactly")
    src_dir = os.path.join(exports, "sources")
    os.makedirs(src_dir)
    sources_s = sync_wall(lambda: update_sources(
        chosen, sources, lines, d.param,
        os.path.join(folder, "cube_correl.fits"),
        os.path.join(folder, "cube_std.fits"),
        d.param["mask_filename_tpl"], d.param["skymask_filename_tpl"],
        os.path.join(folder, "spectra.fits"),
        {"LABEL": d.segmap_label, "MERGED": d.segmap_merged}, "0.1",
        d.FWHM_profiles, os.path.join(src_dir, "source-%0.5d.fits")))
    worst = {}
    for i in chosen:
        name = "source-%05d.fits" % i
        errs = _source_file_errors(
            Source.from_file(os.path.join(src_dir, name)),
            Source.from_file(os.path.join(folder, "sources", name)))
        for rule, err in errs.items():
            worst[rule] = max(worst.get(rule, 0.0), err)
    check(worst and max(worst.values()) <= 1.0, "update_sources of sources "
          f"{chosen} ({sources_s:.3f} s): every extension equals step 11's "
          "file within the pipeline tests' tolerances (largest error over "
          "its limit: " + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
          + ")")
    d.close_logfile()
    del d
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(exports, ignore_errors=True)
    shutil.rmtree(folder, ignore_errors=True)
    out.update(split_merge_source=sid, update_ids=chosen,
               update_masks_s=masks_s, update_sources_s=sources_s,
               update_sources_worst=worst,
               wall_s=time.perf_counter() - t_phase)
    log(f"  phase g: {out['wall_s']:.1f} s")
    return out


# -- phase h ------------------------------------------------------------------
# the full MUSE field, and the memory budget that the JAX package's own
# tools set (tools/bench_e2e.py, tools/make_walkthrough.py): 24 cubes of
# this field (31.8 GB) exceed it, so its sessions run tight
FULL_FIELD = (3681, 300, 300)
TIGHT_BUDGET = "16e9"
# the products that a tight session moves off the card after these steps
OFFLOADS = dict(step01=("cont_dct",), step04=("cube_std",),
                step05=("cube_faint", "cube_correl_min"))
# the two modes' spatial stages differ only in float32 order (the FFTs
# against the DFT matmul chain)
MODE_THRESH_TOL = 1e-3


def _offload_spy(freed):
    """A stand-in for ``TorchEngine.maybe_offload`` that appends, for each
    call, the names, the device bytes of those products that were on the
    card, and ``memory_allocated`` before and after the call (the
    collector off in between, so that no other garbage is freed there)."""
    import torch

    from origin_tpu_torch.pipeline.engine import TorchEngine

    real = TorchEngine.maybe_offload

    def spy(self, *names):
        gc.collect()
        gc.disable()
        try:
            nbytes = 0
            for n in names:
                if self.on_device(n):
                    t = self.get(n)
                    nbytes += t.numel() * t.element_size()
                    del t
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            real(self, *names)
            torch.cuda.synchronize()
            freed.append(dict(names=names, nbytes=nbytes, before=before,
                              after=torch.cuda.memory_allocated()))
        finally:
            gc.enable()

    return spy


def _mode_run(field_fn, mode, budget):
    """Steps 01-11 of the field file with ``ORIGIN_TPU_HBM_BYTES`` set to
    ``budget`` (unset for None), the environment restored afterwards.
    Prints and returns each step's wall and peak device memory, the
    catalogs' numbers, the launches, after steps 01, 04 and 05 which
    offloaded products and raw inputs hold device memory, and what each
    ``maybe_offload`` call freed (``memory_allocated``).  Then holds the
    session's steps 05-07 against the plain versions on the same inputs
    (:func:`_rerun_with_plain`)."""
    import torch

    from origin_tpu_torch.pipeline.engine import TorchEngine
    from origin_tpu_torch.pipeline.session import ORIGIN

    saved = os.environ.pop("ORIGIN_TPU_HBM_BYTES", None)
    if budget is not None:
        os.environ["ORIGIN_TPU_HBM_BYTES"] = budget
    freed = []
    real_offload = TorchEngine.maybe_offload
    TorchEngine.maybe_offload = _offload_spy(freed)
    try:
        gc.collect()
        torch.cuda.empty_cache()
        with _IngestTimes() as ingest_times:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            orig = ORIGIN.init(field_fn, name=f"full_{mode}", path=WORK,
                               loglevel="WARNING", device="cuda")
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            tight = orig.engine.tight_memory
            walls, peaks, resident = {}, {}, {}
            reset_counts()
            for name in STEP_NAMES:
                torch.cuda.reset_peak_memory_stats()
                walls.update(_run_steps(orig, STEP_KWARGS, (name,)))
                peaks[name] = torch.cuda.max_memory_allocated()
                if name in OFFLOADS:
                    resident[name] = dict(
                        {n: orig.engine.on_device(n) for n in OFFLOADS[name]},
                        inputs=orig.engine.inputs_resident())
            counts = read_counts()
            join_ms = ingest_times.join_ms()
    finally:
        TorchEngine.maybe_offload = real_offload
        os.environ.pop("ORIGIN_TPU_HBM_BYTES", None)
        if saved is not None:
            os.environ["ORIGIN_TPU_HBM_BYTES"] = saved
    peak = max(peaks.values())
    check(_reader(orig) == "streamed", f"the {mode} session took the "
          "streamed ingest")
    split = ingest_times.walls
    log(f"  {mode} init: {init_s:.3f} s (decode {split['read']:.3f} s, "
        f"staged copies' host side {split['put']:.3f} s), join wait "
        f"{join_ms} ms")
    for name in STEP_NAMES:
        log(f"  {mode} {name}: {walls[name]:.3f} s, peak "
            f"{peaks[name] / 2**30:.3f} GiB")
    nmask, nsrc, nbytes = _source_files(orig)
    for f in freed:
        log(f"  {mode} maybe_offload{f['names']}: "
            f"{(f['before'] - f['after']) / 2**30:.3f} GiB freed of "
            f"{f['nbytes'] / 2**30:.3f} GiB on the card")
    out = dict(tight=tight, init_s=init_s, join_ms=join_ms,
               ingest=ingest_times.walls, walls=walls, peaks=peaks,
               peak_bytes=peak,
               total=sum(walls.values()), launches=counts,
               resident=resident, freed=freed, mask_files=nmask,
               source_files=nsrc,
               source_bytes=nbytes,
               threshold=float(orig.param["threshold"]),
               threshold_std=float(orig.param["threshold_std"]),
               cat0=len(orig.Cat0), cat1=len(orig.Cat1),
               cat3=_cat3_counts(orig))
    log(f"  {mode}: tight {tight}; steps 01-11 {out['total']:.3f} s, peak "
        f"{peak / 2**30:.3f} GiB ({peak} bytes); thresholds "
        f"{out['threshold']:.6f} / {out['threshold_std']:.6f}, Cat0 "
        f"{out['cat0']}, Cat1 {out['cat1']}, Cat3 lines / sources / comp=1 "
        f"{out['cat3']}; launches {counts}; {nsrc} source files, {nmask} "
        "mask files")
    t0 = time.perf_counter()
    _rerun_with_plain(orig, STEP_KWARGS, "highest", f"{mode} mode, highest,")
    out["plain_rerun_s"] = time.perf_counter() - t0
    orig.close_logfile()
    shutil.rmtree(orig.outpath, ignore_errors=True)
    del orig
    return out


def phase_full_field(small_field_fn):
    """The full 300 x 300 x 3681 field in both memory modes: h1 with the
    card's own budget, h2 under ``ORIGIN_TPU_HBM_BYTES=16e9``; the
    3681 x 100 x 200 field is not tight under that budget."""
    from origin_tpu_torch.pipeline.session import ORIGIN
    from tools_torch.synthetic import make_field

    t0 = time.perf_counter()
    cube, _ = make_field(*FULL_FIELD, seed=7)
    t1 = time.perf_counter()
    field_fn = os.path.join(WORK, "full_field.fits")
    cube.write(field_fn)
    del cube
    t2 = time.perf_counter()
    log(f"  field {FULL_FIELD} generated in {t1 - t0:.1f} s, written to "
        f"{field_fn} in {t2 - t1:.1f} s "
        f"({os.path.getsize(field_fn)} bytes)")
    try:
        log("  h1: the normal mode")
        h1 = _mode_run(field_fn, "normal", None)
        check(not h1["tight"], "h1: a session of the full field on the "
              "card's own budget is not tight")
        check(h1["launches"]["toeplitz_sweep"] == 1, "h1 launched "
              "toeplitz_sweep once")
        log(f"  h2: the tight mode (ORIGIN_TPU_HBM_BYTES={TIGHT_BUDGET})")
        h2 = _mode_run(field_fn, "tight", TIGHT_BUDGET)
    finally:
        os.remove(field_fn)
    check(h2["tight"], "h2: the full field under the budget is tight")
    check(h2["launches"]["toeplitz_sweep"] == 1
          and h2["launches"]["spatial_fsf"] == 0, "h2 launched "
          "toeplitz_sweep once and spatial_fsf never "
          f"({h2['launches']})")
    for name, held in h2["resident"].items():
        check(not any(held.values()), f"h2: after {name} the offloaded "
              f"products and the raw inputs hold no device memory ({held})")
    check([f["names"] for f in h2["freed"]] == list(OFFLOADS.values()),
          "h2 offloaded after steps 01, 04 and 05")
    for f in h2["freed"]:
        fall = f["before"] - f["after"]
        check(f["nbytes"] > 0 and fall >= f["nbytes"], f"h2: "
              f"maybe_offload{f['names']} lowered memory_allocated by "
              f"{fall} >= the products' {f['nbytes']} device bytes")
    check(all(all(held.values()) for held in h1["resident"].values()),
          "h1: the products and the raw inputs stay on the card in the "
          f"normal mode ({h1['resident']})")
    check(h2["peak_bytes"] <= float(TIGHT_BUDGET)
          and h2["peak_bytes"] < h1["peak_bytes"], "h2's peak "
          f"{h2['peak_bytes']} bytes is within the budget and below h1's "
          f"{h1['peak_bytes']}")
    for key in ("cat0", "cat1"):
        check(abs(h2[key] - h1[key]) <= COUNT_TOL, f"h2 {key} {h2[key]} "
              f"within {COUNT_TOL} line of h1's {h1[key]}")
    dthr = abs(h2["threshold"] - h1["threshold"])
    check(dthr <= MODE_THRESH_TOL, f"h2's correl threshold within "
          f"{dthr:.3g} <= {MODE_THRESH_TOL} of h1's")
    log(f"  Cat3 lines / sources / comp=1: h1 {h1['cat3']}, h2 {h2['cat3']}")
    check(h2["source_files"] == h2["cat3"][1], "h2: step 11 wrote one file "
          f"per Cat3 source ({h2['source_files']})")
    os.environ["ORIGIN_TPU_HBM_BYTES"] = TIGHT_BUDGET
    try:
        small = ORIGIN.init(small_field_fn, name="small_tight", path=WORK,
                            loglevel="WARNING", device="cuda")
    finally:
        del os.environ["ORIGIN_TPU_HBM_BYTES"]
    small_tight = small.engine.tight_memory
    small.close_logfile()
    shutil.rmtree(small.outpath, ignore_errors=True)
    check(not small_tight, "the 3681 x 100 x 200 field under the same "
          "budget is not tight")
    return dict(generate_s=t1 - t0, write_s=t2 - t1, normal=h1, tight=h2)


# -- phase i ------------------------------------------------------------------
# the live cubes of phase 5's cold run that phase i holds its mesh runs to
PINNED = ("cube_faint", "cube_local_max", "cube_profile")
# the mesh of one card: four row shards of the field's 100 rows, 25 rows
# each (the 25 x 25 FSF's halo is 12), every slot on this card
MESH_SP = 4
MESH_CARD = "cuda:0"
# tests/test_parallel.py's rules for a mesh session against one device
MESH_THRESH_TOL = dict(threshold=0.05, threshold_std=0.02)
MESH_MAPO2_AGREE = 0.99
MESH_ATOL, MESH_RTOL = 2e-3, 1e-3
MESH_PROFILE_AGREE = 0.999
# i5: the mosaic tools on four fields of the field's geometry and FSF
# (tools_torch/synthetic.py's make_field, seeds 100-103): dp=2 x sp=2,
# 50-row tiles
MOSAIC_FIELDS = 4
MOSAIC_PSF = 25
# i2: at most this share of the voxels may be a local maximum on one side
# only (a float32 near-tie of its box)
MESH_TIES_MAX = 1e-6


def _keyed(cat):
    import numpy as np

    return sorted(zip(*(np.asarray(cat[k]).tolist()
                        for k in ("x0", "y0", "z0", "comp"))))


def _mesh(devices):
    from origin_tpu_torch.parallel import make_mesh

    return make_mesh(len(devices), dp=1, devices=devices)


def _mesh_session(field_fn, name, devices, kwargs, names=STEP_NAMES):
    """Steps ``names`` of the field file on a ``(1 x len(devices))`` mesh:
    each step's wall and peak device memory (reset before it), the
    counters set to 0 just before the steps and read just after."""
    import torch

    from origin_tpu_torch.pipeline.session import ORIGIN

    gc.collect()
    torch.cuda.empty_cache()
    orig = ORIGIN.init(field_fn, name=name, path=WORK, loglevel="WARNING",
                       device=devices[0], mesh=_mesh(devices))
    walls, peaks = {}, {}
    reset_counts()
    with _Timer(ORIGIN, "write") as writes:
        for step in names:
            torch.cuda.reset_peak_memory_stats()
            walls.update(_run_steps(orig, kwargs, (step,)))
            peaks[step] = torch.cuda.max_memory_allocated()
    counts = read_counts()
    for step in names:
        log(f"  {name} {step}: {walls[step]:.3f} s, peak "
            f"{peaks[step] / 2**30:.3f} GiB")
    if writes.walls:
        nfiles, nbytes = _session_files(orig.outpath)
        log(f"  {name}: step 11's session write {writes.walls[0]:.3f} s, "
            f"{nfiles} files, {nbytes} bytes")
    out = dict(devices=devices, walls=walls, peaks=peaks,
               write_s=writes.walls[0] if writes.walls else None,
               total=sum(walls.values()), peak_bytes=max(peaks.values()),
               launches=counts,
               threshold=float(orig.param["threshold"]),
               threshold_std=float(orig.param["threshold_std"]),
               cat0=len(orig.Cat0), cat1=len(orig.Cat1))
    log(f"  {name} on {devices}: {out['total']:.3f} s, peak "
        f"{out['peak_bytes'] / 2**30:.3f} GiB ({out['peak_bytes']} bytes); "
        f"thresholds {out['threshold']:.6f} / {out['threshold_std']:.6f}, "
        f"Cat0 {out['cat0']}, Cat1 {out['cat1']}; launches {counts}")
    return orig, out


def _hold_mesh_session(label, orig, ref, out):
    """A mesh session of the field against phase 5's single-device run, by
    tests/test_parallel.py's rules: the thresholds, mapO2, and at phase
    5's thresholds Cat0 and Cat1 keyed (x0, y0, z0, comp); after steps
    10-11 the Cat3 counts and the number of source and mask files."""
    import numpy as np

    from origin_tpu_torch.parallel.mesh import RowShards

    # parked by step 11's write: read back, as a resumed session's
    tiles = getattr(orig.cube_faint, "tensor", None)
    check(isinstance(tiles, RowShards)
          and [str(d) for d in tiles.devices] == out["devices"],
          f"{label}: cube_faint comes back in {len(out['devices'])} row "
          f"shards on {out['devices']}")
    del tiles
    for key, tol in MESH_THRESH_TOL.items():
        d = abs(out[key] - ref[key])
        check(d <= tol, f"{label}: {key} within {d:.3g} <= {tol} of phase "
              "5's")
    agree = float(np.mean(orig.mapO2.data == ref["mapO2"]))
    out["mapO2_agreement"] = agree
    check(agree > MESH_MAPO2_AGREE, f"{label}: mapO2 agrees with phase 5's "
          f"on {agree:.5f} > {MESH_MAPO2_AGREE} of the spaxels")
    for name in ("Cat0", "Cat1"):
        check(_keyed(getattr(orig, name)) == _keyed(ref[name]),
              f"{label}: {name} at phase 5's thresholds equals phase 5's "
              f"keyed by (x0, y0, z0, comp) ({len(getattr(orig, name))} "
              "rows)")
    got3, want3 = _cat3_counts(orig), (
        len(ref["Cat3_lines"]), len(ref["Cat3_sources"]),
        int((np.asarray(ref["Cat3_sources"]["comp"]) == 1).sum()))
    files = _source_files(orig)[:2]
    out.update(cat3=got3, files=files)
    check(got3 == want3 and files == tuple(ref["files"]), f"{label}: Cat3 "
          f"{got3} and {files[1]} source / {files[0]} mask files equal "
          "phase 5's")


def _extrema_ties(far, correls, tol, size=3):
    """The voxels of ``far`` (where two local-maxima cubes disagree) that
    are not near-ties: a voxel is a local maximum on one side only where
    the filter's comparison of it with the largest of its box's other
    voxels is decided by float32 order.  Where the two correl cubes
    differ by at most ``e`` anywhere, such a voxel lies within ``2 e`` of
    that largest other voxel in both, so ``tol`` is twice the measured
    gap and the tie must hold in each of ``correls``.  Returns (``far``
    without the near-ties, the near-ties' largest gaps)."""
    import numpy as np

    far = far.copy()
    gaps = []
    h = size // 2
    for z, y, x in np.argwhere(far):
        sl = tuple(slice(max(0, c - h), c + h + 1) for c in (z, y, x))
        gap = 0.0
        for correl in correls:
            box = correl[sl].astype(np.float64)
            box[z - sl[0].start, y - sl[1].start, x - sl[2].start] = -np.inf
            gap = max(gap, abs(float(box.max()) - float(correl[z, y, x])))
        if gap <= tol:
            far[z, y, x] = False
            gaps.append(gap)
    return far, gaps


def phase_mesh(field, ref, bf16x3, smi):
    """The multi-device path on one card: mesh sessions of the field whose
    slots all name ``cuda:0`` (i1-i4), and the two mosaic tools (i5)."""
    import numpy as np
    import torch

    from origin_tpu_torch.ops import glr
    from origin_tpu_torch.parallel import mesh as mesh_mod
    from origin_tpu_torch.pipeline.engine import MeshEngine
    from origin_tpu_torch.pipeline.session import ORIGIN

    field_fn, _ = field
    t_phase = time.perf_counter()
    ncards = torch.cuda.device_count()
    log(f"  {smi}; torch.cuda.device_count() = {ncards}")
    at_ref = dict(STEP_KWARGS, step07=dict(
        threshold=ref["threshold"], threshold_std=ref["threshold_std"]))
    one_card = [MESH_CARD] * MESH_SP
    out = {}

    log(f"  i1: steps 01-11 on a {MESH_SP}-slot mesh of cuda:0 (highest)")
    orig, i1 = _mesh_session(field_fn, "mesh_i1", one_card, at_ref)
    check(i1["launches"]["toeplitz_sweep"] == MESH_SP
          and i1["launches"]["spatial_fsf"] == 0,
          f"i1 launched toeplitz_sweep once per tile ({MESH_SP}) and the "
          f"spatial kernel never ({i1['launches']})")
    _hold_mesh_session("i1", orig, ref, i1)
    kinds = _product_kinds(orig.outpath, PRODUCT_KINDS)
    check(kinds == dict(PRODUCT_KINDS, cube_faint="float32"),
          "i1: the closing write stored cube_faint dense, as the JAX mesh "
          "session stores it, and the other products in their kinds "
          f"({kinds})")
    out["i1"] = i1

    log("  i4: i1's session loaded with mesh=, step 07")
    t0 = time.perf_counter()
    res = ORIGIN.load(orig.outpath, device=MESH_CARD, mesh=_mesh(one_card),
                      loglevel="WARNING")
    load_s = time.perf_counter() - t0
    check(isinstance(res.engine, MeshEngine), "i4: the loaded session runs "
          "on a MeshEngine")
    step07_s = sync_wall(lambda: res.step07_detection(**at_ref["step07"]))
    check(_keyed(res.Cat1) == _keyed(orig.Cat1), "i4: the resumed session's "
          f"Cat1 equals i1's ({len(res.Cat1)} rows; load {load_s:.3f} s, "
          f"step 07 {step07_s:.3f} s)")
    out["i4"] = dict(load_s=load_s, step07_s=step07_s, cat1=len(res.Cat1))
    for o in (res, orig):
        o.close_logfile()
    shutil.rmtree(orig.outpath, ignore_errors=True)
    del res, orig

    log("  i2: steps 05-07 of a mesh session fed phase 5's cube_faint")
    gc.collect()
    torch.cuda.empty_cache()
    pin = ORIGIN.init(field_fn, name="mesh_i2", path=WORK,
                      loglevel="WARNING", device=MESH_CARD,
                      mesh=_mesh(one_card))
    pin.step01_preprocessing()
    pin.engine.load_state({"cube_faint": ref["pinned"]["cube_faint"]})
    real, calls = mesh_mod.spectral_sweep, []

    def recorded(*args, **kwargs):
        got = real(*args, **kwargs)
        # copies: glr_tile masks the outputs in place
        calls.append((args, kwargs, tuple(t.clone() for t in got)))
        return got

    mesh_mod.spectral_sweep = recorded
    reset_counts()
    try:
        wall = sync_wall(pin.step05_compute_TGLR)
    finally:
        mesh_mod.spectral_sweep = real
    counts = read_counts()
    check(counts["toeplitz_sweep"] == MESH_SP == len(calls), f"i2: step 05 "
          f"launched toeplitz_sweep once per tile ({counts}; {wall:.3f} s)")
    pinned = ref["pinned"]
    errs = {}
    for name, got in (("cube_correl", pin.cube_correl.data),
                      ("cube_local_max", pin.cube_local_max.data),
                      ("maxmap", pin.maxmap.data)):
        want = ref["maxmap"] if name == "maxmap" else pinned[name]
        far = np.abs(got - want) > MESH_ATOL + MESH_RTOL * np.abs(want)
        ties = ""
        if name == "cube_local_max":
            tol = 2 * errs["cube_correl"]
            far, gaps = _extrema_ties(
                far, (pinned["cube_correl"], pin.cube_correl.data), tol)
            cap = MESH_TIES_MAX * far.size
            check(len(gaps) <= cap, f"i2: {len(gaps)} voxels are a local "
                  f"maximum on one side only, <= {cap:.1f} "
                  f"({MESH_TIES_MAX:g} of the voxels)")
            ties = (f"; {len(gaps)} voxels a local maximum on one side "
                    "only, each a near-tie of its box in both sessions' "
                    f"correl within {tol:.3g}, twice the correl gap "
                    f"(largest {max(gaps, default=0):.3g})")
            errs["local_max_ties"] = gaps
        errs[name] = float(np.abs(np.where(far, 0, got - want)).max())
        check(not far.any(), f"i2: {name} within atol {MESH_ATOL} + rtol "
              f"{MESH_RTOL} of phase 5's (max abs err {errs[name]:.3g}"
              f"{ties})")
    agree = float(np.mean(pin.cube_profile.data == pinned["cube_profile"]))
    check(agree > MESH_PROFILE_AGREE, f"i2: profiles agree on {agree:.6f} > "
          f"{MESH_PROFILE_AGREE} of the voxels")
    tiles = []
    for i, (args, kwargs, got) in enumerate(calls):
        x, n, t_num, t_den, pad_left, nz = args
        plain = glr.toeplitz_sweep(*args, **kwargs)
        err, mism, gap = _hold_sweep(f"i2 tile {i} {tuple(x.shape)}", got,
                                     plain, x, n, t_num, t_den, pad_left)
        tiles.append(dict(shape=list(x.shape), max_abs_err=err,
                          mismatches=mism, tie_gap=gap))
        del plain
    del calls
    pin.step06_compute_purity_threshold(purity=0.8)
    pin.step07_detection(**at_ref["step07"])
    check(_keyed(pin.Cat1) == _keyed(ref["Cat1"]), "i2: Cat1 at phase 5's "
          "thresholds equals phase 5's")

    def by_position(cat):
        order = np.lexsort((np.asarray(cat["z0"]), np.asarray(cat["y0"]),
                            np.asarray(cat["x0"])))
        return np.asarray(cat["T_GLR"], float)[order]

    a, b = by_position(pin.Cat1), by_position(ref["Cat1"])
    fin = np.isfinite(b)
    dt = float(np.abs(a[fin] - b[fin]).max()) if fin.any() else 0.0
    check(dt <= MESH_ATOL, f"i2: Cat1's T_GLR within {dt:.3g} <= "
          f"{MESH_ATOL} of phase 5's")
    out["i2"] = dict(step05_s=wall, max_abs_err=errs,
                     profile_agreement=agree, tiles=tiles, tglr_err=dt,
                     threshold=float(pin.param["threshold"]))
    pin.close_logfile()
    shutil.rmtree(pin.outpath, ignore_errors=True)
    del pin

    log("  i3: steps 01-07 of a bf16x3 mesh session at sp=2")
    prev = os.environ.get("ORIGIN_TPU_PRECISION")
    os.environ["ORIGIN_TPU_PRECISION"] = "bf16x3"
    try:
        orig, i3 = _mesh_session(field_fn, "mesh_i3", [MESH_CARD] * 2,
                                 STEP_KWARGS, FRONT_STEPS)
    finally:
        if prev is None:
            os.environ.pop("ORIGIN_TPU_PRECISION")
        else:
            os.environ["ORIGIN_TPU_PRECISION"] = prev
    check(i3["launches"]["toeplitz_sweep_bf16x3"] == 2
          and i3["launches"]["toeplitz_sweep"] == 0,
          f"i3 launched the bf16x3 sweep once per tile ({i3['launches']})")
    d = bf16x3["field"]["cold"]
    for key in ("cat0", "cat1"):
        check(abs(i3[key] - d[key]) <= COUNT_TOL, f"i3 {key} {i3[key]} "
              f"within {COUNT_TOL} line of phase d's {d[key]}")
    log(f"  i3: correl threshold {i3['threshold']:.6f}, phase d's "
        f"{d['threshold']:.6f}")
    out["i3"] = i3
    orig.close_logfile()
    shutil.rmtree(orig.outpath, ignore_errors=True)
    del orig

    if ncards >= 2:
        sp = ncards if (FIELD[1] % ncards == 0
                        and FIELD[1] // ncards >= 12) else 2
        cards = [f"cuda:{i}" for i in range(sp)]
        log(f"  i1 on {sp} cards: {cards}")
        orig, multi = _mesh_session(field_fn, "mesh_cards", cards, at_ref)
        _hold_mesh_session("i1 on cards", orig, ref, multi)
        out["cards"] = multi
        orig.close_logfile()
        shutil.rmtree(orig.outpath, ignore_errors=True)
        del orig
    else:
        log(f"  one card (torch.cuda.device_count() = {ncards}): no "
            "multi-card run was made; the one-card mesh above ran")
        out["cards"] = None

    log(f"  i5: tools_torch/mosaic_batch.py at dp=2 x sp=2 on cuda:0 over "
        f"{MOSAIC_FIELDS} fields of {FIELD} with the {MOSAIC_PSF}x"
        f"{MOSAIC_PSF} FSF, then tools_torch/mosaic_distributed.py --dryrun "
        "--device cuda on them")
    out["i5"] = _mesh_tools()
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"  phase i: {out['wall_s']:.1f} s")
    return out


def _mesh_tools():
    import numpy as np
    import torch

    from origin_tpu_torch.parallel import ShardedPipeline, make_mesh
    from tools_torch import mosaic_batch
    from tools_torch.synthetic import make_field

    nz, ny, nx = FIELD
    work = os.path.join(WORK, "mosaic")
    os.makedirs(work, exist_ok=True)
    t0 = time.perf_counter()
    paths = []
    for i in range(MOSAIC_FIELDS):
        fn = os.path.join(work, f"field_{i:02d}.fits")
        make_field(nz, ny, nx, seed=100 + i)[0].write(fn)
        paths.append(fn)
    log(f"  i5: {MOSAIC_FIELDS} fields of {FIELD} written in "
        f"{time.perf_counter() - t0:.1f} s")
    psf, profiles = mosaic_batch.instrument(nz, MOSAIC_PSF)
    th = np.linspace(1.0, 8.0, 20)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    pipe = ShardedPipeline(make_mesh(4, dp=2, devices=[MESH_CARD] * 4), nz,
                           ny, nx, psf, profiles, thresholds=th)
    setup = time.perf_counter() - t0
    events = []
    results = mosaic_batch.run_batches(
        pipe, paths, dp=2, on_event=lambda *ev: events.append(ev))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    starts = {b: t for k, b, t in events if k == "compute_start"}
    computes = [t - starts[b] for k, b, t in events if k == "compute_done"]
    check(counts["toeplitz_sweep"] == 2 * len(paths), f"i5: the batch "
          f"launched toeplitz_sweep once per tile ({counts}; {wall:.3f} s "
          f"for {len(paths)} fields of {FIELD}, of which the pipeline's "
          f"set-up {setup:.3f} s and the batches' compute "
          f"{', '.join(f'{c:.3f}' for c in computes)} s; peak "
          f"{peak / 2**30:.3f} GiB)")
    single = ShardedPipeline(make_mesh(2, dp=1, devices=[MESH_CARD] * 2), nz,
                             ny, nx, psf, profiles, thresholds=th)
    for p, got in results:
        _, _, want, _ = single(*mosaic_batch.load_fields([p]))
        check(np.array_equal(got, want[0]), f"i5: {os.path.basename(p)}'s "
              f"counts equal its single-field run ({got[:3]}...)")
    del pipe, single
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools_torch",
                                      "mosaic_distributed.py"),
         "--dryrun", "--device", MESH_CARD.split(":")[0], "--workdir", work,
         "--nz", str(nz), "--ny", str(ny), "--nx", str(nx),
         "--psf-size", str(MOSAIC_PSF), "--timeout", "300"],
        capture_output=True, text=True, timeout=400, cwd=REPO)
    dist_s = time.perf_counter() - t0
    tail = "" if proc.returncode == 0 else (
        f": {proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    check(proc.returncode == 0, "i5: the distributed dryrun ran (rc "
          f"{proc.returncode}){tail}")
    report = json.loads(proc.stdout[proc.stdout.index("{"):])
    check(report["geometry"] == list(FIELD)
          and report["psf_size"] == MOSAIC_PSF
          and report["fields"] == MOSAIC_FIELDS, "i5: the dryrun ran on "
          f"the {MOSAIC_FIELDS} fields of {FIELD} with the {MOSAIC_PSF}x"
          f"{MOSAIC_PSF} FSF")
    log(f"  i5: distributed dryrun {dist_s:.1f} s: "
        + json.dumps(report["per_host"]))
    check(report["counts_match_single_process"] is True,
          "i5: the two processes' counts match a single-process run "
          f"(equal: {report['counts_equal_single_process']})")
    shutil.rmtree(work, ignore_errors=True)
    return dict(batch_s=wall, setup_s=setup, compute_s=computes,
                peak_bytes=peak, launches=counts, dryrun_s=dist_s,
                dryrun=report)


# -- phase a ------------------------------------------------------------------
def _spatial_problem(nz, ny, nx, nfields, dev, psf_size=25, seed=3):
    """The field's FSF (the synthetic cubes' Moffat model) for nz channels,
    F fields scaled apart and random weights, and a random cube."""
    import numpy as np
    import torch

    from origin_tpu_torch.core import MoffatFSF
    from origin_tpu_torch.ops import glr
    from origin_tpu_torch.ops.convolve import fft2_shape

    g = torch.Generator(device=dev).manual_seed(seed)
    cube = torch.randn((nz, ny, nx), generator=g, device=dev)
    fsf = MoffatFSF(fwhm_pol=[-0.2, 0.7], beta_pol=[2.8], pixstep=0.2)
    one = fsf.get_3darray(4750.0 + 1.25 * np.arange(nz),
                          (psf_size, psf_size)).astype(np.float32)
    psfs = torch.from_numpy(np.stack([one * (1 + 0.1 * f)
                                      for f in range(nfields)])).to(dev)
    wmaps = (None if nfields == 1 else
             torch.rand((nfields, ny, nx), generator=g, device=dev) * 0.8
             + 0.2)
    fshape2 = fft2_shape((ny, nx), (psf_size, psf_size))
    kern_hats, _ = glr.precompute_spatial(psfs, wmaps, ny, nx, fshape2)
    factors = {k: torch.from_numpy(v).to(dev) for k, v in
               glr.dft_spatial_factors(ny, nx, fshape2,
                                       (psf_size, psf_size)).items()}
    args = (cube, kern_hats.real.contiguous(), kern_hats.imag.contiguous(),
            wmaps, factors)
    return args, psfs


def _spatial_bound(args, precision):
    """Bytes: the cube in, out, the spectra and the factors (weights in
    mosaic mode); operations: the 12 products' FMAs, twice FLOPs, three
    bf16 passes in bf16x3 (tensor-core rate) or float32 (CUDA cores)."""
    cube, kr, _, wmaps, factors = args
    nfields, nz, fy, fxr = kr.shape
    ny, nx = cube.shape[1:]
    fmas = nfields * nz * (4 * ny * nx * fxr + 8 * fy * ny * fxr)
    nbytes = 4 * (2 * cube.numel() + 2 * kr.numel()
                  + sum(f.numel() for f in factors.values())
                  + (0 if wmaps is None else wmaps.numel()))
    if precision == "bf16x3":
        return _bound(nbytes, 3 * 2 * fmas, PEAK_BF16)
    return _bound(nbytes, 2 * fmas, PEAK_FP32)


def _rms(t):
    return float(t.double().square().mean().sqrt())


def _library_conv(cube, psfs):
    """One torch call computing the single-field stage: a depthwise
    conv2d (a correlation) with each channel's zero-mean FSF, 'same'."""
    import torch

    kern = psfs[0] - psfs[0].mean(dim=(1, 2), keepdim=True)
    pad = kern.shape[-1] // 2
    return lambda: torch.nn.functional.conv2d(
        cube[None], kern[:, None], padding=pad, groups=cube.shape[0])[0]


def phase_spatial():
    import torch

    from origin_tpu_torch.device import set_precision
    from origin_tpu_torch.ops import glr, spatial
    from origin_tpu_torch.ops.spatial import spatial_fsf

    set_precision()  # float32 cuBLAS and cuDNN, as a session sets it
    dev = torch.device("cuda")
    out = {}
    cases = (("field", FIELD, 1), ("mosaic", (256, 100, 200), 2),
             ("300x300", (256, 300, 300), 1))
    for label, shape, nfields in cases:
        args, psfs = _spatial_problem(*shape, nfields, dev)
        res, outs = {}, {}
        ny, fy = shape[1], args[1].shape[2]
        for precision in ("highest", "bf16x3"):
            x3 = int(precision == "bf16x3")
            lib = spatial._library()
            tk = spatial._tile_columns(lib, ny, fy, x3)
            smem = lib.spatial_fsf_smem_bytes(ny, fy, tk, x3)
            log(f"  {label} {precision}: kx tiles of {tk}, {smem} bytes of "
                f"shared memory per block")
            got = spatial_fsf(*args, precision=precision)
            torch.cuda.synchronize()
            ref = glr.glr_spatial_matmul(*args, precision=precision)
            err = float((got - ref).abs().max())
            rms_err = _rms(got - ref)
            scale = float(ref.abs().max())
            outs[precision] = got
            del got, ref
            tol = SPATIAL_ATOL[precision]
            check(err <= tol, f"spatial {label} {shape} F={nfields} "
                  f"{precision}: max abs err {err:.3g} <= {tol} (values up "
                  f"to {scale:.3g}, RMS err {rms_err:.3g})")
            ms = _time_cuda(lambda: spatial_fsf(*args, precision=precision),
                            reps=3)
            plain_ms = _time_cuda(lambda: glr.glr_spatial_matmul(
                *args, precision=precision), reps=3)
            bound, by = _spatial_bound(args, precision)
            res[precision] = dict(max_abs_err=err, rms_err=rms_err, ms=ms,
                                  plain_ms=plain_ms, bound_ms=bound,
                                  bound_by=by, tk=tk, smem_bytes=smem)
            log(f"  {label} {precision}: kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms, bound {bound:.3f} ms ({by})")
        sep = _rms(outs.pop("bf16x3") - outs.pop("highest"))
        res["bf16x3"]["rms_from_highest"] = sep
        noise, err3 = res["highest"]["rms_err"], res["bf16x3"]["rms_err"]
        check(sep >= SPLIT_SEPARATION * noise,
              f"spatial {label} bf16x3 kernel splits: RMS {sep:.3g} from the "
              f"highest kernel >= {SPLIT_SEPARATION:g} x the float32 order "
              f"noise {noise:.3g} (ratio {sep / noise:.3g})")
        check(sep >= SPLIT_NEARER * err3,
              f"spatial {label} bf16x3 kernel splits where its plain version "
              f"does: RMS {err3:.3g} from it, {sep:.3g} from the highest "
              f"kernel (ratio {sep / err3:.3g} >= {SPLIT_NEARER:g})")
        if nfields == 1 and label == "field":
            conv = _library_conv(args[0], psfs)
            lib_err = float((conv() - glr.glr_spatial_matmul(*args))
                            .abs().max())
            lib_ms = _time_cuda(conv, reps=3)
            log(f"  {label} library conv2d: {lib_ms:.3f} ms (max abs diff "
                f"from the cuBLAS chain {lib_err:.3g})")
            res.update(library_ms=lib_ms, library_err=lib_err)
        out[label] = res
        del args, psfs
        torch.cuda.empty_cache()
    return out


# -- phase c ------------------------------------------------------------------
def phase_spaxel_major():
    """Each spaxel-major entry called once on the field at K=3 and K=20
    (the counted path), held to its plain version and, bit for bit, to the
    float32 sweep's outputs on the cube layout; then timed through the
    entry and as one kernel launch with taps and outputs prebuilt."""
    import torch

    from origin_tpu_torch.core.profiles import DICO_3FWHM, DICO_FWHM_2_12
    from origin_tpu_torch.ops import kernels
    from origin_tpu_torch.ops.glr import _pack_profiles
    from origin_tpu_torch.ops.sweep import (
        launch_sweep, spectral_sweep, sweep_taps)

    dev = torch.device("cuda")
    nz = FIELD[0]
    x, n = _sweep_inputs(dev)
    s = x[0].numel()
    xs = x.reshape(nz, -1).T.contiguous()
    ns = n.reshape(nz, -1).T.contiguous()
    back = lambda a: a.T.reshape(FIELD)  # noqa: E731
    correl, cmin = torch.empty_like(xs), torch.empty_like(xs)
    pidx = torch.empty(xs.shape, dtype=torch.int32, device=dev)
    out = {}
    for dico in (DICO_3FWHM, DICO_FWHM_2_12):
        t_num, t_den, pad_left, prepped = _banks(dico, nz, dev)
        k = t_num.shape[0]
        bank, bank2, centers = _pack_profiles(prepped)
        mf_taps, mf_pad = kernels.mf_taps(bank, bank2, centers)
        entries = dict(
            matched_filter_spectral=(
                lambda: kernels.matched_filter_spectral(xs, ns, bank, bank2,
                                                        centers),
                lambda: kernels.matched_filter_plain(
                    xs, ns, torch.from_numpy(bank), torch.from_numpy(bank2),
                    centers),
                tuple(torch.from_numpy(t).to(dev) for t in mf_taps), mf_pad),
            banded_matmul_spectral=(
                lambda: kernels.banded_matmul_spectral(xs, ns, t_num, t_den,
                                                       pad_left, nz),
                lambda: kernels.banded_matmul_plain(xs, ns, t_num, t_den,
                                                    pad_left, nz),
                sweep_taps(t_num, t_den), pad_left))
        cube = spectral_sweep(x, n, t_num, t_den, pad_left, nz)
        bound, by = _sweep_bound(t_num, t_den, x.numel(), 4, PEAK_FP32)
        for name, (entry, plain, taps, pad) in entries.items():
            what = f"{name} K={k}"
            reset_counts()
            got = entry()
            torch.cuda.synchronize()
            launches = read_counts()[name]
            check(launches == 1, f"{what}: one launch through its entry "
                  "point")
            c, m, p = got
            check(torch.equal(back(c), cube[0])
                  and torch.equal(back(m), cube[2])
                  and torch.equal(back(p), cube[1].to(torch.int32)),
                  f"{what}: correl, cmin and index equal the float32 "
                  "sweep's on the cube layout bit for bit")
            ref = plain()
            cr, mr, pr = ref
            err, mism, gap = _hold_sweep(what, (back(c), back(p), back(m)),
                                         (back(cr), back(pr), back(mr)), x,
                                         n, t_num, t_den, pad_left)
            del got, ref, c, m, p, cr, mr, pr
            ms = _time_cuda(lambda: launch_sweep(
                xs, ns, taps, pad, pidx, correl, cmin, nz, s,
                spaxel_major=True), reps=10)
            entry_ms = _time_cuda(entry, reps=10)
            plain_ms = _time_cuda(plain, reps=2 if k == 3 else 1)
            log(f"  {what}: kernel {ms:.3f} ms, entry {entry_ms:.3f} ms, "
                f"plain {plain_ms:.3f} ms, bound {bound:.3f} ms ({by}): "
                f"{bound / ms:.1%} of the bound")
            out.setdefault(name, {})[k] = dict(
                launches=launches, max_abs_err=err, mismatches=mism,
                tie_gap=gap, ms=ms, entry_ms=entry_ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by)
        del cube
    return out


# -- phase d ------------------------------------------------------------------
def phase_bf16x3(field, highest):
    prev = os.environ.get("ORIGIN_TPU_PRECISION")
    os.environ["ORIGIN_TPU_PRECISION"] = "bf16x3"
    try:
        log("  minicube:")
        mini = phase_minicube("bf16x3", FRONT_STEPS)
        log("  field:")
        runs, counts, _ = phase_field(field, "bf16x3", FRONT_STEPS)
    finally:
        if prev is None:
            os.environ.pop("ORIGIN_TPU_PRECISION")
        else:
            os.environ["ORIGIN_TPU_PRECISION"] = prev
    check(counts["toeplitz_sweep"] == 0 and counts["spatial_fsf"] == 1,
          "the bf16x3 field run took the JAX route: one spatial launch, "
          "no float32 sweep")
    him, hif = highest["minicube"], highest["field"]["cold"]
    got = runs["cold"]
    check(all(mini[k] == him[k] for k in ("cat0", "cat1")),
          f"minicube bf16x3 Cat0/Cat1 {mini['cat0']}/{mini['cat1']} equal "
          f"the highest run's")
    dmini = abs(mini["threshold"] - him["threshold"])
    check(dmini <= BF16X3_MINI_THRESH_TOL, f"minicube bf16x3 correl "
          f"threshold within {dmini:.3g} <= {BF16X3_MINI_THRESH_TOL} of "
          f"highest")
    for key in ("cat0", "cat1"):
        check(abs(got[key] - hif[key]) <= COUNT_TOL,
              f"field bf16x3 {key} {got[key]} within {COUNT_TOL} line of "
              f"highest's {hif[key]}")
    dfield = abs(got["threshold"] - hif["threshold"])
    check(dfield <= BF16X3_FIELD_THRESH_TOL, f"field bf16x3 correl "
          f"threshold within {dfield:.3g} <= {BF16X3_FIELD_THRESH_TOL} of "
          f"highest")
    return dict(minicube=mini, field=runs, launches=counts)


# -- phase j ------------------------------------------------------------------
SURVEY_RUN = ["--device", "cuda", "--purity", "0.8", "--loglevel", "WARNING",
              "--no-sources"]


class _IngestTimes:
    """Swaps in wrappers that time a session init's ingest: the streamed
    decode (``IngestPlan.read``, host wall), the eager decode (``Cube``'s
    file read), the host side of the staged copies (``_StagedInputs.put``:
    the copy into a pinned slab and the enqueue) and, for each join at
    step 01, how long the current stream waits on the copy stream (CUDA
    events on either side of the join)."""

    def __enter__(self):
        from origin_tpu_torch.core.containers import Cube
        from origin_tpu_torch.pipeline import engine, ingest

        self.walls = dict(read=0.0, cube=0.0, put=0.0)
        self.joins = []
        self.saved = [(ingest.IngestPlan, "read"), (Cube, "_load"),
                      (engine._StagedInputs, "put"),
                      (engine._StagedInputs, "join")]
        self.saved = [(o, n, getattr(o, n)) for o, n in self.saved]
        for (owner, name, fn), key in zip(self.saved[:3],
                                          ("read", "cube", "put")):
            setattr(owner, name, self._timed(fn, key))
        join = self.saved[3][2]

        def timed_join(staged):
            import torch

            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            out = join(staged)
            e1.record()
            self.joins.append((e0, e1))
            return out

        engine._StagedInputs.join = timed_join
        return self

    def _timed(self, fn, key):
        def wrapped(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.walls[key] += time.perf_counter() - t0
        return wrapped

    def join_ms(self):
        import torch

        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.joins]

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)


def _reader(orig):
    """The reader the session's init took, from the first ingest line of
    its log."""
    with open(orig.logfile) as fh:
        lines = [ln for ln in fh if " ingest: " in ln]
    if not lines:
        return None
    return "streamed" if "ingest: streamed" in lines[0] else "eager"


def _h2d_copies(prof, path):
    """The host-to-device copies of a profile's chrome trace: their
    kinds (Pinned or Pageable), count, bytes and device ms."""
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    os.remove(path)
    out = {}
    for ev in events:
        if ev.get("cat") != "gpu_memcpy" or "HtoD" not in ev.get("name", ""):
            continue
        row = out.setdefault(ev["name"], dict(count=0, bytes=0, ms=0.0))
        row["count"] += 1
        row["bytes"] += int(ev.get("args", {}).get("bytes", 0))
        row["ms"] += float(ev.get("dur", 0.0)) / 1e3
    return out


def _ingest_init(field_fn, route, name, profile=False):
    """``ORIGIN.init`` of the field file by ``route`` (``"streamed"``, or
    ``"eager"`` under ``ORIGIN_TPU_STREAM_INGEST=0``): its wall (device
    drained at the end) and ingest split, and, unless ``profile``, step
    01's wall and the join's wait; with ``profile``, the init and the join
    under ``torch.profiler`` and the host-to-device copies of the trace."""
    import torch

    from origin_tpu_torch.pipeline.session import ORIGIN

    gc.collect()
    torch.cuda.empty_cache()
    saved = os.environ.pop("ORIGIN_TPU_STREAM_INGEST", None)
    if route == "eager":
        os.environ["ORIGIN_TPU_STREAM_INGEST"] = "0"
    out = {}
    try:
        with _IngestTimes() as times:
            if profile:
                acts = [torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts) as prof:
                    orig = ORIGIN.init(field_fn, name=name, path=WORK,
                                       loglevel="WARNING", device="cuda")
                    orig.engine.input_cube()
                    torch.cuda.synchronize()
                out["h2d"] = _h2d_copies(prof, os.path.join(
                    WORK, f"trace_{name}.json"))
            else:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                orig = ORIGIN.init(field_fn, name=name, path=WORK,
                                   loglevel="WARNING", device="cuda")
                torch.cuda.synchronize()
                out["init_s"] = time.perf_counter() - t0
                out["step01_s"] = _run_steps(orig, STEP_KWARGS,
                                             ("step01",))["step01"]
                out["join_ms"] = times.join_ms()
        out.update(times.walls)
    finally:
        os.environ.pop("ORIGIN_TPU_STREAM_INGEST", None)
        if saved is not None:
            os.environ["ORIGIN_TPU_STREAM_INGEST"] = saved
    out["reader"] = _reader(orig)
    return orig, out


def phase_ingest(field, ref, smi):
    """j1: the field file's init streamed and eager, their inputs equal on
    the card bit for bit, the walls, the join's wait and step 01, then one
    profiled init of each route for the kind and rate of its copies; j2:
    the CLI survey of two copies of the field and a bad file with and
    without ``--overlap-ingest``."""
    import torch

    from origin_tpu_torch.core import Table

    field_fn, _ = field
    t_phase = time.perf_counter()
    out = {}
    cube_bytes = 4 * FIELD[0] * FIELD[1] * FIELD[2]

    # j1: the two routes timed in turns, then their inputs held bit for bit
    sessions = []
    for i, route in enumerate(("streamed", "eager", "eager", "streamed")):
        orig, got = _ingest_init(field_fn, route, f"ingest_{route}_{i}")
        check(got["reader"] == route, f"j1: the {route} init took the "
              f"{route} reader")
        sessions.append(orig)
        out.setdefault(route, dict(runs=[]))["runs"].append(got)
        log(f"  j1 {route}: init {got['init_s']:.3f} s (decode "
            f"{got['read'] or got['cube']:.3f} s, staged copies' host side "
            f"{got['put']:.3f} s), join wait {got['join_ms']} ms, step 01 "
            f"{got['step01_s']:.3f} s")
    first = sessions[0].engine._inputs
    for orig in sessions[1:]:
        for name in ("cube", "var", "mask"):
            got = orig.engine._inputs[name]
            check(got.is_cuda and torch.equal(got, first[name]),
                  f"j1: {orig.name}'s input {name} equals {sessions[0].name}"
                  "'s on the card bit for bit")
    for orig in sessions:
        orig.close_logfile()
        shutil.rmtree(orig.outpath, ignore_errors=True)
    del sessions, first, got, orig
    # one profiled init of each route: the kind and rate of the copies
    for route in ("streamed", "eager"):
        orig, got = _ingest_init(field_fn, route, f"ingest_{route}_prof",
                                 profile=True)
        check(got["reader"] == route, f"j1: the profiled {route} init took "
              f"the {route} reader")
        h2d = got["h2d"]
        pinned = {k: v for k, v in h2d.items() if "Pinned" in k}
        nbytes = sum(v["bytes"] for v in pinned.values())
        ms = sum(v["ms"] for v in pinned.values())
        out[route].update(h2d=h2d, h2d_gbps=nbytes / ms / 1e6 if ms else 0)
        log(f"  j1 {route} (profiled): host-to-device copies {h2d}; "
            f"pinned {nbytes} bytes in {ms:.3f} ms of device time, "
            f"{out[route]['h2d_gbps']:.2f} GB/s ({smi})")
        check(nbytes >= 2 * cube_bytes, f"j1 {route}: the data and variance "
              f"({2 * cube_bytes} bytes) went Pinned -> Device")
        orig.close_logfile()
        shutil.rmtree(orig.outpath, ignore_errors=True)
        del orig

    # j2: the survey of [a, b, bad]: with the flag, b is initialized while
    # a is current and the bad file while b is
    work = os.path.join(WORK, "survey")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    cubes = [os.path.join(work, n) for n in ("a.fits", "b.fits", "bad.fits")]
    for fn in cubes[:2]:
        shutil.copyfile(field_fn, fn)
    with open(cubes[2], "wb") as fh:
        fh.write(b"not a FITS file")
    for flag in ([], ["--overlap-ingest"]):
        label = "overlap" if flag else "plain"
        gc.collect()
        torch.cuda.empty_cache()
        reset_counts()
        rc, _, wall = _cli(["run", *cubes, *SURVEY_RUN, "--name", label,
                            "--path", work, *flag])
        counts = read_counts()
        log(f"  j2 {label}: rc {rc}, {wall:.3f} s, launches {counts} ({smi})")
        check(rc == 1, f"j2 {label}: the survey reports the bad file (rc 1)")
        check(counts["toeplitz_sweep"] == 2, f"j2 {label}: toeplitz_sweep "
              "launched once per good field")
        for stem in ("a", "b"):
            folder = os.path.join(work, f"{label}-{stem}")
            for name in ("Cat0", "Cat1"):
                cat = Table.read(os.path.join(folder, name + ".fits"))
                check(_same_rows(cat, ref[name], 0.0), f"j2 {label} field "
                      f"{stem}: {name} ({len(cat)} rows) equals phase 5's "
                      "cold run bit for bit")
            shutil.rmtree(folder, ignore_errors=True)
        out[f"survey_{label}_s"] = wall
    shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  j2: the survey of 2 fields and a bad file: plain "
        f"{out['survey_plain_s']:.3f} s, --overlap-ingest "
        f"{out['survey_overlap_s']:.3f} s; phase j {out['seconds']:.1f} s")
    return out


# -- phase k ------------------------------------------------------------------
def _event_wall(fn):
    """``(fn(), wall in s)``, the wall between two CUDA events recorded
    around the call, the device drained before it."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / 1e3


def _same_table(a, b):
    import numpy as np

    return a.colnames == b.colnames and all(
        np.array_equal(np.asarray(a[c]), np.asarray(b[c]), equal_nan=True)
        for c in a.colnames)


def phase_library(ref, smi):
    """The library surface on the field's products of phase 5's cold run,
    through the top-level names of ``origin_tpu_torch``:
    ``Correlation_GLR_test`` on its cube_faint (kernel 1 once, held to the
    plain sweep on the card's spatial stage and to the session's
    cube_correl), ``glr_spectral`` on that spatial stage (kernel 3 once,
    held to its plain version and bit for bit to ``glr_spectral_mxu``) and
    ``Compute_threshold_purity`` on its local extrema and segmap (the
    session's threshold and purity table)."""
    import numpy as np
    import torch

    import origin_tpu_torch as otp
    from origin_tpu_torch.core.profiles import (
        DICO_3FWHM, default_dictionary_path, load_dictionary)
    from origin_tpu_torch.ops import glr, kernels
    from origin_tpu_torch.ops.convolve import fft2_shape

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    out = {}
    faint = ref["pinned"]["cube_faint"]
    nz, ny, nx = faint.shape
    profiles, _ = load_dictionary(default_dictionary_path(DICO_3FWHM))

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    # k1: the reference's Correlation_GLR_test, on the card
    reset_counts()
    got, wall = _event_wall(lambda: otp.Correlation_GLR_test(
        faint, ref["psf"], ref["wfields"], profiles, device="cuda"))
    counts = read_counts()
    check(counts["toeplitz_sweep"] == 1
          and sum(counts.values()) == 1, "Correlation_GLR_test launched "
          f"kernel 1 once and no other kernel ({counts})")
    check(all(isinstance(a, np.ndarray) and a.flags.writeable for a in got)
          and got[1].dtype == np.uint8, "Correlation_GLR_test returned "
          "writable numpy arrays, uint8 indices")
    out["correlation_glr_test"] = dict(wall_s=wall, launches=counts)
    # its spatial stage again on the card, to hold the sweep against
    psfs = np.asarray(ref["psf"], np.float32)[None]
    kern_r, kern_i, factors, norm = glr.spatial_operands(
        up(psfs), None, ny, nx, fft2_shape((ny, nx), psfs.shape[-2:]))
    cube_fsf = glr.glr_spatial_matmul(up(faint), kern_r, kern_i, None,
                                      factors)
    del kern_r, kern_i, factors
    prepped = glr.prepare_profiles(profiles)
    t_num, t_den, pad_left, _ = glr.pack_profiles_toeplitz(
        prepped, block=min(128, nz))
    t_num, t_den = up(t_num), up(t_den)
    got = tuple(up(a) for a in got)
    plain = glr.toeplitz_sweep(cube_fsf, norm, t_num, t_den, pad_left, nz)
    err, mism, gap = _hold_sweep("Correlation_GLR_test", got, plain,
                                 cube_fsf, norm, t_num, t_den, pad_left)
    del plain
    session = up(ref["pinned"]["cube_correl"])
    kept = session != 0  # the session zeroes the masked voxels
    diff = float((got[0] - session)[kept].abs().max())
    check(diff <= SWEEP_ATOL, "Correlation_GLR_test on the session's "
          f"cube_faint gives its step-05 cube_correl (max abs err {diff:.3g}"
          f" on {int(kept.sum())} voxels)")
    del session, kept
    out["correlation_glr_test"].update(max_abs_err=err, mismatches=mism,
                                       tie_gap=gap, vs_session=diff)

    # k2: glr_spectral on that spatial stage: kernel 3 on its library path
    bank, bank2, centers = glr._pack_profiles(prepped)
    reset_counts()
    mf, wall_mf = _event_wall(lambda: glr.glr_spectral(
        cube_fsf, norm, bank, bank2, centers, nz))
    counts = read_counts()
    check(counts["matched_filter_spectral"] == 1
          and sum(counts.values()) == 1, "glr_spectral launched kernel 3 "
          f"once and no other kernel ({counts})")
    check(mf[1].dtype == torch.uint8 and mf[0].shape == faint.shape,
          "glr_spectral: (Nz, Ny, Nx) outputs, uint8 indices")
    s = ny * nx
    cr, mr, pr = kernels.matched_filter_plain(
        cube_fsf.reshape(nz, s).T.contiguous(),
        norm.reshape(nz, s).T.contiguous(), torch.from_numpy(bank),
        torch.from_numpy(bank2), centers)

    def back(a):
        return a.T.reshape(nz, ny, nx)

    err3, mism3, gap3 = _hold_sweep(
        "glr_spectral", mf, (back(cr), back(pr).to(mf[1].dtype), back(mr)),
        cube_fsf, norm, t_num, t_den, pad_left)
    del cr, mr, pr
    mxu = glr.glr_spectral_mxu(cube_fsf, norm, t_num, t_den, pad_left, nz)
    check(all(torch.equal(a, b) for a, b in zip(mf, mxu)),
          "glr_spectral (kernel 3) equals glr_spectral_mxu (kernel 1) on "
          "the same spatial stage bit for bit")
    check(all(torch.equal(a, b) for a, b in zip(mxu, got)),
          "glr_spectral_mxu on the card's spatial stage equals "
          "Correlation_GLR_test's output bit for bit")
    out["glr_spectral"] = dict(wall_s=wall_mf, launches=counts,
                               max_abs_err=err3, mismatches=mism3,
                               tie_gap=gap3)
    del mf, mxu, got, cube_fsf, norm

    # k3: Compute_threshold_purity on the session's step-06 inputs
    purity = STEP_KWARGS["step06"]["purity"]
    clmax = ref["pinned"]["cube_local_max"]
    clmin = ref["pinned"]["cube_local_min"]
    seg, pval = ref["segmap_purity"], ref["Pval"]
    grid = np.asarray(pval["Tval_r"])
    (thr, tab), wall_p = _event_wall(lambda: otp.Compute_threshold_purity(
        purity, clmax, clmin, seg, threshlist=grid, device="cuda"))
    check(thr == ref["threshold"] and _same_table(tab, pval),
          f"Compute_threshold_purity on step 06's grid: threshold {thr!r} "
          "and the purity table equal the session's")
    # the auto grid: the float64 linspace between the statistics read back,
    # as the JAX package's single form builds it (step 06 builds the
    # float32 grid of the pair form)
    (thr_a, tab_a), wall_a = _event_wall(lambda: otp.Compute_threshold_purity(
        purity, clmax, clmin, seg, device="cuda"))
    grid_a = np.asarray(tab_a["Tval_r"])
    check(abs(thr_a - ref["threshold"]) <= MODE_THRESH_TOL
          and np.array_equal(np.asarray(tab_a["Det_M"]),
                             np.asarray(pval["Det_M"]))
          and np.array_equal(np.asarray(tab_a["Det_m"]),
                             np.asarray(pval["Det_m"])),
          f"Compute_threshold_purity on its auto grid: threshold {thr_a!r} "
          f"within {MODE_THRESH_TOL} of the session's {ref['threshold']!r}, "
          "the counts equal (grids apart by "
          f"{float(np.abs(grid_a - grid).max()):.3g})")
    out["purity"] = dict(wall_s=wall_p, threshold=thr, wall_auto_s=wall_a,
                         threshold_auto=thr_a,
                         grid_gap=float(np.abs(grid_a - grid).max()))
    out["seconds"] = time.perf_counter() - t_phase
    log(f"  walls (CUDA events, {smi}): Correlation_GLR_test {wall:.3f} s, "
        f"glr_spectral {wall_mf:.3f} s, Compute_threshold_purity {wall_p:.3f}"
        f" s (auto grid {wall_a:.3f} s); phase k {out['seconds']:.1f} s")
    return out


def _kernel_line(res):
    sweep, sweep3 = res["sweep"][3], res["sweep_bf16x3"][3]
    spatial = res["spatial"]["field"]
    rows = dict(
        toeplitz_sweep=dict(
            launches=res["field"]["cold"]["launches"]["toeplitz_sweep"],
            mesh_launches=res["mesh"]["i1"]["launches"]["toeplitz_sweep"],
            library_launches=res["library"]["correlation_glr_test"][
                "launches"]["toeplitz_sweep"],
            library_ms=None, **sweep),
        toeplitz_sweep_bf16x3=dict(
            launches=res["bf16x3"]["launches"]["toeplitz_sweep_bf16x3"],
            mesh_launches=res["mesh"]["i3"]["launches"][
                "toeplitz_sweep_bf16x3"],
            library_ms=None, **sweep3),
        spatial_fsf=dict(
            launches=res["bf16x3"]["launches"]["spatial_fsf"],
            library_ms=spatial["library_ms"], precision="bf16x3",
            **spatial["bf16x3"]),
        matched_filter_spectral=dict(
            library_ms=None, **dict(
                res["spaxel_major"]["matched_filter_spectral"][3],
                launches=res["library"]["glr_spectral"]["launches"][
                    "matched_filter_spectral"])),
        banded_matmul_spectral=dict(
            library_ms=None, **res["spaxel_major"]["banded_matmul_spectral"][
                3]))
    keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    out = []
    for name, row in rows.items():
        source, replaces = KERNEL_SOURCES[name]
        out.append(dict(name=name, route="cuda", source=source,
                        replaces=replaces, **{k: row[k] for k in keys}))
        for key in ("precision", "mesh_launches", "library_launches"):
            if key in row:
                out[-1][key] = row[key]
    return {"kernels": out}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible to torch", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import origin_tpu_torch  # noqa: F401  (fails outside the repository)
    from tools_torch.synthetic import make_field

    os.makedirs(WORK, exist_ok=True)
    t_start = time.perf_counter()
    res = {}
    log("[1] versions")
    res["versions"] = phase_versions()
    log("[2] build")
    res["build"] = phase_build()
    log("[3] sweep kernel vs plain at %dx%dx%d" % FIELD)
    res["sweep"] = phase_sweep_parity("highest")
    log("[4] minicube steps 01-11 on cuda")
    res["minicube"] = phase_minicube()
    log("[5] field %dx%dx%d steps 01-11 on cuda" % FIELD)
    t0 = time.perf_counter()
    cube, lines = make_field(*FIELD, seed=7)
    field = (os.path.join(WORK, "field.fits"), lines)
    cube.write(field[0])
    del cube
    log(f"  field {FIELD} generated and written to {field[0]} in "
        f"{time.perf_counter() - t0:.1f} s")
    res["field"], _, reference = phase_field(field)
    log("[a] spatial FSF kernel vs plain")
    res["spatial"] = phase_spatial()
    log("[b] bf16x3 sweep kernel vs plain at %dx%dx%d" % FIELD)
    res["sweep_bf16x3"] = phase_sweep_parity("bf16x3", res["sweep"])
    log("[c] spaxel-major sweeps vs plain at %dx%dx%d" % FIELD)
    res["spaxel_major"] = phase_spaxel_major()
    log("[d] minicube and field steps 01-07 in bf16x3")
    res["bf16x3"] = phase_bf16x3(field, res)
    log("[e] resume on cuda: field steps 01-04, write, load, steps 05-11")
    res["resume"] = phase_resume(field, reference)
    log("[f] compact resume on cuda: field steps 01-04 in the default "
        "session files (B2), load (C2), steps 05-11")
    res["compact"] = phase_compact(field, reference)
    log("[g] the user surface on cuda: the CLI's field run, status and "
        "info, reference exports, source updates")
    res["surface"] = phase_surface(field, reference)
    log("[h] the full field %dx%dx%d steps 01-11 on cuda in the normal "
        "mode (h1) and the tight mode (h2)" % FULL_FIELD)
    res["full_field"] = phase_full_field(field[0])
    log("[i] the multi-device path on one card: mesh sessions of the field "
        "(steps 01-11, a pinned step 05, bf16x3, resume) and the mosaic "
        "tools")
    res["mesh"] = phase_mesh(field, reference, res["bf16x3"],
                             res["versions"]["nvidia_smi"])
    log("[j] the streamed ingest on cuda: the field's init streamed and "
        "eager (j1), the CLI survey with --overlap-ingest (j2)")
    res["ingest"] = phase_ingest(field, reference,
                                 res["versions"]["nvidia_smi"])
    log("[k] the library surface on cuda: Correlation_GLR_test, "
        "glr_spectral and Compute_threshold_purity on phase 5's products")
    res["library"] = phase_library(reference, res["versions"]["nvidia_smi"])
    jaxed = sorted(m for m in sys.modules if m.split(".")[0] in
                   ("jax", "origin_tpu"))
    check(not jaxed, "nothing of JAX or of the JAX package was imported "
          f"({jaxed[:5]})")
    res["seconds"] = time.perf_counter() - t_start
    log(f"chip_smoke: {res['seconds']:.1f} s")

    line = _kernel_line(res)
    os.makedirs(os.path.dirname(RESULTS), exist_ok=True)
    with open(RESULTS, "w") as fh:
        json.dump(dict(res, kernels=line["kernels"]), fh, indent=1,
                  default=str)
    log(res["versions"]["nvidia_smi"])
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
