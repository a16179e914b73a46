#!/usr/bin/env python3
"""Multi-process mosaic detection over ``torch.distributed``.

The port's copy of ``tools/mosaic_distributed.py``.  The single-process
batcher (``tools_torch/mosaic_batch.py``) overlaps FITS ingest with the
sharded detection step in one process; this tool spreads the fields over
processes (one per host, or per card).  Every process

1. joins a gloo process group (``torch.distributed.init_process_group``
   with a ``file://`` init method under the work directory, so that runs
   side by side do not clash on a port),
2. ingests ITS OWN fields from FITS, overlapped with the previous field's
   compute on a host thread,
3. runs its own ``ShardedPipeline`` (a ``(1 x sp)`` mesh of its devices),
4. exchanges only the ``(T,)`` purity count vectors, as an ``all_gather``
   of host tensors: no cube data crosses processes.

Every process runs the same number of rounds (an ``all_gather`` each):
an uneven split wraps around the field list, and a repeated field gives
the same counts.

The collective runs over gloo on host tensors, so the processes may share
one card (``--device cuda`` maps process ``r`` to ``cuda:{r % cards}``).
An NCCL group with one card per process waits for a machine with one card
per process.

The two-process dryrun that validates this path:

    python tools_torch/mosaic_distributed.py --dryrun --device cpu

spawns 2 processes with 2 slots each and checks their count tables
against a single-process run of the same fields (``--nz/--ny/--nx`` and
``--psf-size`` set their geometry; fields already in ``--workdir`` are
read, not written again); it prints a JSON report
(``counts_match_single_process``, ``per_host`` with ``ingest_s`` and
``compute_s``).
"""

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

NZ, NY, NX = 120, 32, 24  # dryrun field geometry (tiny, CPU-friendly)
PSF_SIZE = 9
THRESHOLDS = np.linspace(1.0, 8.0, 20)
NPROCS = 2
SP = 2


def _make_fields(workdir, nfields, nz, ny, nx):
    from tools_torch.synthetic import make_minicube

    paths = []
    for i in range(nfields):
        fn = os.path.join(workdir, f"field_{i:02d}.fits")
        if not os.path.exists(fn):
            make_minicube(fn, nz=nz, ny=ny, nx=nx, seed=100 + i)
        paths.append(fn)
    return paths


def _pipeline(args, devices):
    from origin_tpu_torch.parallel import ShardedPipeline, make_mesh
    from tools_torch.mosaic_batch import instrument

    psf, profiles = instrument(args.nz, psf_size=args.psf_size)
    mesh = make_mesh(len(devices), dp=1, devices=devices)
    return ShardedPipeline(mesh, args.nz, args.ny, args.nx, psf,
                           profiles[:2], thresholds=THRESHOLDS)


def _worker_device(device, rank):
    import torch

    if device.startswith("cuda") and ":" not in device:
        return f"cuda:{rank % torch.cuda.device_count()}"
    return device


def run_worker(args):
    """One process of the group."""
    import torch
    import torch.distributed as dist

    from tools_torch.mosaic_batch import load_fields

    if args.device == "cpu":
        torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=args.init,
                            world_size=args.nprocs, rank=args.pid)
    try:
        all_fields = json.loads(args.fields)
        per = -(-len(all_fields) // args.nprocs)
        mine = [all_fields[(args.pid + k * args.nprocs) % len(all_fields)]
                for k in range(per)]
        dev = _worker_device(args.device, args.pid)
        pipe = _pipeline(args, [dev] * args.sp)

        def load(name):
            t0 = time.perf_counter()
            out = load_fields([os.path.join(args.workdir, name)])
            return out, time.perf_counter() - t0

        t_ingest = t_compute = 0.0
        table = {}
        with ThreadPoolExecutor(max_workers=1) as ingest:
            nxt = ingest.submit(load, mine[0])
            for k, name in enumerate(mine):
                (cubes, variances, masks), dt = nxt.result()
                t_ingest += dt
                if k + 1 < len(mine):
                    nxt = ingest.submit(load, mine[k + 1])
                t0 = time.perf_counter()
                _, _, cmax, _ = pipe(cubes, variances, masks)
                t_compute += time.perf_counter() - t0
                # the round's only traffic: every process's (T,) counts
                mine_t = torch.as_tensor(cmax[0], dtype=torch.int64)
                got = [torch.empty_like(mine_t) for _ in range(args.nprocs)]
                dist.all_gather(got, mine_t)
                for r, counts in enumerate(got):
                    field = all_fields[(r + k * args.nprocs)
                                       % len(all_fields)]
                    table[field] = counts.tolist()
        out = dict(pid=args.pid, nprocs=args.nprocs, device=dev,
                   slots=args.sp, fields=table,
                   ingest_s=round(t_ingest, 3),
                   compute_s=round(t_compute, 3),
                   ingest_overlap=round(min(t_ingest, t_compute)
                                        / max(t_ingest, 1e-9), 3))
        print("WORKER_RESULT " + json.dumps(out), flush=True)
    finally:
        dist.destroy_process_group()


def run_dryrun(args):
    """Spawn the 2-process validation and check it against one process."""
    workdir = os.path.abspath(args.workdir)
    os.makedirs(workdir, exist_ok=True)
    paths = _make_fields(workdir, 4, args.nz, args.ny, args.nx)
    names = json.dumps([os.path.basename(p) for p in paths])
    init = os.path.join(workdir, "pg_init")
    if os.path.exists(init):
        os.remove(init)
    procs = []
    for pid in range(NPROCS):
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--init", "file://" + init, "--nprocs", str(NPROCS),
             "--pid", str(pid), "--workdir", workdir, "--fields", names,
             "--device", args.device, "--sp", str(args.sp),
             "--nz", str(args.nz), "--ny", str(args.ny), "--nx", str(args.nx),
             "--psf-size", str(args.psf_size)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=args.timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            print(o)
            raise RuntimeError(f"worker {pid} failed (rc {p.returncode})")

    workers = []
    for o in outs:
        for line in o.splitlines():
            if line.startswith("WORKER_RESULT "):
                workers.append(json.loads(line[len("WORKER_RESULT "):]))
    if len(workers) != NPROCS:
        raise RuntimeError(f"{len(workers)} worker results: {outs}")

    # cross-check: one process, the same fields, the same sp tiling
    from tools_torch.mosaic_batch import load_fields

    pipe = _pipeline(args, [_worker_device(args.device, 0)] * args.sp)
    expected = {}
    for p in paths:
        _, _, cmax, _ = pipe(*load_fields([p]))
        expected[os.path.basename(p)] = cmax[0].tolist()

    ok = True
    for w in workers:
        if set(w["fields"]) != set(expected):
            print(f"MISSING fields in worker {w['pid']}: "
                  f"{sorted(w['fields'])}")
            ok = False
        for name, counts in w["fields"].items():
            # the same tiles on the same device type: the counts agree;
            # the JAX tool's slack of 2 voxels at a scanned threshold
            # covers float32 order between its meshes
            diff = np.abs(np.asarray(counts) - np.asarray(expected[name]))
            if diff.max() > 2:
                print(f"MISMATCH {name}: {counts} != {expected[name]}")
                ok = False
    report = dict(
        dryrun=f"{NPROCS} processes x {args.sp} slots on {args.device} "
               "(torch.distributed, gloo)",
        fields=len(paths),
        geometry=[args.nz, args.ny, args.nx],
        psf_size=args.psf_size,
        counts_match_single_process=ok,
        counts_equal_single_process=all(
            w["fields"][n] == expected[n] for w in workers
            for n in w["fields"]),
        per_host=[{k: w[k] for k in
                   ("pid", "device", "ingest_s", "compute_s",
                    "ingest_overlap")}
                  for w in workers],
    )
    print(json.dumps(report, indent=1))
    if not ok:
        raise SystemExit(1)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", action="store_true")
    ap.add_argument("--init", default=None,
                    help="init method of the process group (worker mode)")
    ap.add_argument("--nprocs", type=int, default=NPROCS)
    ap.add_argument("--pid", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="device of the slots: cuda (the default; process "
                    "r on cuda:{r % cards}) or cpu")
    ap.add_argument("--sp", type=int, default=SP)
    ap.add_argument("--workdir",
                    default=os.path.join(REPO, "build", "mosaic_distributed"))
    ap.add_argument("--fields", default="[]",
                    help="JSON list of field FITS basenames (worker mode)")
    ap.add_argument("--nz", type=int, default=NZ)
    ap.add_argument("--ny", type=int, default=NY)
    ap.add_argument("--nx", type=int, default=NX)
    ap.add_argument("--psf-size", type=int, default=PSF_SIZE,
                    help="edge of the FSF in pixels (a MUSE field's: 25)")
    ap.add_argument("--timeout", type=float, default=600,
                    help="seconds each worker may take (dryrun)")
    args = ap.parse_args()

    if args.init:
        run_worker(args)
    else:
        run_dryrun(args)


if __name__ == "__main__":
    main()
