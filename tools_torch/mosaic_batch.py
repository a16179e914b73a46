#!/usr/bin/env python3
"""Mosaic batch detection: stream fields from FITS through a device mesh.

The port's copy of ``tools/mosaic_batch.py``: a grid of MUSE fields
processed as a (dp x sp)-sharded batch.  Fields are read (or synthesized,
``tools_torch/synthetic.py``) on the host through the port's ``core.Cube``,
grouped into dp-sized batches, and each batch runs through the sharded
detection front end (``origin_tpu_torch.parallel.ShardedPipeline``) while
the next batch's FITS ingest overlaps on a host thread.

The devices are explicit: ``--device cuda`` (the default) or ``cpu``,
repeated dp x sp times, or a ``--devices`` list (``cuda:0,cuda:1,...``;
a device may repeat).

Usage:
    python tools_torch/mosaic_batch.py --fields 3x3 --ny 48 --nx 48 \
        --nz 200 --dp 2 --sp 2 --device cpu
"""

import argparse
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def load_fields(batch_paths):
    """(cubes, variances, masks) stacks for one dp-sized batch of FITS."""
    from origin_tpu_torch.core import Cube

    cubes, variances, masks = [], [], []
    for p in batch_paths:
        c = Cube(p)
        cubes.append(c.filled(0).astype(np.float32))
        v = c.var_filled(np.inf)
        variances.append(
            v.astype(np.float32) if v is not None
            else np.ones_like(cubes[-1])
        )
        masks.append(c.masked_invalid())
    return np.stack(cubes), np.stack(variances), np.stack(masks)


def run_batches(pipe, paths, dp, on_event=None):
    """Drive the overlapped ingest/compute loop over ``paths``.

    ``pipe`` is a ShardedPipeline whose mesh has ``dp`` data-parallel
    rows; fields are grouped into dp-sized batches, the next batch's FITS
    ingest runs on a host thread while the current batch computes, and the
    last batch is padded by repeating its first field (padded results
    discarded).  Returns ``[(path, counts_max_vector), ...]`` in input
    order.  ``on_event(kind, index, t)`` (optional) receives
    ('ingest_start'|'ingest_done', batch_index, perf_counter) and
    ('compute_start'|'compute_done', batch_index, perf_counter), from
    which the tests read that the ingest of batch N+1 overlaps the compute
    of batch N.
    """
    def note(kind, idx):
        if on_event is not None:
            on_event(kind, idx, time.perf_counter())

    def load_batch(idx, batch_paths):
        note("ingest_start", idx)
        out = load_fields(batch_paths)
        note("ingest_done", idx)
        return out

    batches = [paths[i: i + dp] for i in range(0, len(paths), dp)]
    # pad the last batch by repeating its first field (results discarded)
    pad_last = dp - len(batches[-1])
    batches[-1] = batches[-1] + batches[-1][:1] * pad_last

    results = []
    with ThreadPoolExecutor(max_workers=1) as ingest:
        nxt = ingest.submit(load_batch, 0, batches[0])
        for bi, batch_paths in enumerate(batches):
            cubes, variances, masks = nxt.result()
            if bi + 1 < len(batches):
                nxt = ingest.submit(load_batch, bi + 1, batches[bi + 1])
            note("compute_start", bi)
            _, _, cmax, _ = pipe(cubes, variances, masks)  # host counts
            note("compute_done", bi)
            keep = dp if bi + 1 < len(batches) else dp - pad_last
            for j in range(keep):
                results.append((batch_paths[j], cmax[j]))
    return results


def instrument(nz, psf_size=13):
    """The tools' FSF and profiles (the JAX tool's), for ``nz`` channels."""
    from origin_tpu_torch.core import MoffatFSF
    from origin_tpu_torch.core.profiles import gaussian_profile

    fsf = MoffatFSF(fwhm_pol=[-0.2, 0.7], beta_pol=[2.8], pixstep=0.2)
    psf = fsf.get_3darray(
        np.linspace(4750, 9300, nz), (psf_size, psf_size)
    ).astype(np.float32)
    profiles = [gaussian_profile(f, 41, 20) for f in (2.0, 6.7, 12.0)]
    return psf, profiles


def mesh_devices(device, n, devices=None):
    """The mesh's device list: ``devices`` (comma-separated) or ``device``
    repeated ``n`` times."""
    if devices:
        return [d.strip() for d in devices.split(",")]
    return [device] * n


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fields", default="3x3", help="grid, e.g. 3x3")
    ap.add_argument("--nz", type=int, default=200)
    ap.add_argument("--ny", type=int, default=48)
    ap.add_argument("--nx", type=int, default=48)
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--sp", type=int, default=2)
    ap.add_argument("--psf-size", type=int, default=13,
                    help="edge of the FSF in pixels (a MUSE field's: 25)")
    ap.add_argument("--device", default="cuda",
                    help="device of every slot: cuda (the default) or cpu")
    ap.add_argument("--devices", default=None,
                    help="comma-separated dp*sp slot devices (overrides "
                    "--device; a device may repeat)")
    ap.add_argument("--workdir",
                    default=os.path.join(REPO, "build", "mosaic_batch"))
    args = ap.parse_args()

    from origin_tpu_torch.parallel import ShardedPipeline, make_mesh
    from tools_torch.synthetic import make_minicube

    gy, gx = (int(v) for v in args.fields.split("x"))
    nfields = gy * gx
    os.makedirs(args.workdir, exist_ok=True)

    # synthesize the mosaic fields on disk (one FITS per field), standing in
    # for a survey's exposure store
    paths = []
    for i in range(nfields):
        fn = os.path.join(args.workdir, f"field_{i:02d}.fits")
        if not os.path.exists(fn):
            make_minicube(fn, nz=args.nz, ny=args.ny, nx=args.nx, seed=100 + i)
        paths.append(fn)
    print(f"{nfields} fields of {args.nz}x{args.ny}x{args.nx} in "
          f"{args.workdir}")

    devices = mesh_devices(args.device, args.dp * args.sp, args.devices)
    mesh = make_mesh(len(devices), dp=args.dp, devices=devices)
    print(f"mesh: {mesh}")

    psf, profiles = instrument(args.nz, args.psf_size)
    pipe = ShardedPipeline(mesh, args.nz, args.ny, args.nx, psf, profiles,
                           thresholds=np.linspace(1.0, 8.0, 20))

    t0 = time.perf_counter()
    results = run_batches(pipe, paths, args.dp)
    dt = time.perf_counter() - t0
    vox = nfields * args.nz * args.ny * args.nx / 1e6
    print(f"{nfields} fields in {dt:.1f}s "
          f"({vox / dt:.1f} Mvox/s aggregate, ingest overlapped)")
    for p, counts in results[:3]:
        print(os.path.basename(p), "detections@thr0:", int(counts[0]))


if __name__ == "__main__":
    main()
