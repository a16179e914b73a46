"""tools_torch/mosaic_batch.py, the cases of tests/test_mosaic_batch.py:
the overlapped ingest/compute loop on a 2 x 2 grid of synthetic fields
over a dp=2 x sp=4 mesh of CPU slots.  Each field's counts equal its own
single-field run on the same sp=4 tiling; an odd field count pads the last
batch and discards the copy; the ingest of batch N+1 starts before the
compute of batch N ends, read from the loop's event order."""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from tools_torch import mosaic_batch  # noqa: E402
from tools_torch.synthetic import make_minicube  # noqa: E402

from origin_tpu_torch.core import MoffatFSF  # noqa: E402
from origin_tpu_torch.core.profiles import gaussian_profile  # noqa: E402
from origin_tpu_torch.parallel import (  # noqa: E402
    ShardedPipeline, make_mesh, sharded_detect,
)

torch.set_num_threads(2)


def cpu_mesh(n, dp=1):
    return make_mesh(n, dp=dp, devices=["cpu"] * n)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """A 2x2 grid of small synthetic fields on disk."""
    workdir = tmp_path_factory.mktemp("mosaic_grid")
    nz, ny, nx = 120, 24, 20
    paths = []
    for i in range(4):
        fn = str(workdir / f"field_{i:02d}.fits")
        make_minicube(fn, nz=nz, ny=ny, nx=nx, seed=100 + i)
        paths.append(fn)
    return paths, (nz, ny, nx)


@pytest.fixture(scope="module")
def pipe(grid):
    _, (nz, ny, nx) = grid
    fsf = MoffatFSF(fwhm_pol=[-0.2, 0.7], beta_pol=[2.8], pixstep=0.2)
    psf = fsf.get_3darray(np.linspace(4750, 9300, nz), (7, 7)).astype(
        np.float32)
    profiles = [gaussian_profile(f, 41, 20) for f in (2.0, 6.7)]
    thresholds = np.linspace(1.0, 8.0, 12)
    mesh = cpu_mesh(8, dp=2)  # dp=2 x sp=4
    return ShardedPipeline(mesh, nz, ny, nx, psf, profiles,
                           thresholds=thresholds), (psf, profiles,
                                                    thresholds)


def test_batch_counts_match_single_field_runs(grid, pipe):
    paths, _ = grid
    pipe, (psf, profiles, thresholds) = pipe
    results = mosaic_batch.run_batches(pipe, paths, dp=2)
    assert [p for p, _ in results] == paths  # input order preserved
    for p, counts in results:
        cubes, variances, masks = mosaic_batch.load_fields([p])
        _, _, cmax_ref, _ = sharded_detect(
            cpu_mesh(4), cubes[0], variances[0], masks[0], psf, profiles,
            thresholds=thresholds)
        np.testing.assert_array_equal(counts, cmax_ref)
        assert int(counts[0]) > 0  # a non-trivial scan


def test_odd_field_count_pads_last_batch(grid, pipe):
    paths, _ = grid
    pipe, _ = pipe
    res3 = mosaic_batch.run_batches(pipe, paths[:3], dp=2)
    res4 = mosaic_batch.run_batches(pipe, paths, dp=2)
    assert [p for p, _ in res3] == paths[:3]
    for (p3, c3), (p4, c4) in zip(res3, res4[:3]):
        assert p3 == p4
        np.testing.assert_array_equal(c3, c4)


def test_ingest_overlaps_compute(grid, pipe):
    paths, _ = grid
    pipe, _ = pipe
    events = []
    mosaic_batch.run_batches(pipe, paths, dp=2,
                             on_event=lambda *ev: events.append(ev))
    order = [(kind, idx) for kind, idx, _ in
             sorted(events, key=lambda ev: ev[2])]
    # batch 1's ingest starts on the ingest thread before batch 0's
    # compute ends, and each batch computes after its ingest finished
    assert order.index(("ingest_start", 1)) < order.index(
        ("compute_done", 0))
    for bi in range(2):
        assert order.index(("ingest_done", bi)) < order.index(
            ("compute_start", bi))
