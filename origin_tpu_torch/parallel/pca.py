"""Area-parallel greedy PCA over a mesh: step 04's area loop dealt onto
the mesh's slots.

Torch port of :mod:`origin_tpu.parallel.pca`.  The areas of the area map
are dealt onto the ``sp`` slots largest first (:func:`balance_slots`);
each area's columns are gathered from the row shards that hold them, in
the area's flat order, onto its slot's device, where
:func:`~origin_tpu_torch.ops.pca.greedy_pca` cleans them (its whole
power-iteration budget, as everywhere in the port), and the cleaned
columns are scattered back into the shards.  The areas are disjoint and
each runs the very same function on the very same columns as the single
device's loop, so the result is that loop's bit for bit on one device
type.  The JAX package pads every area to one bucketed width so that one
program runs them all; nothing is padded here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.pca import greedy_pca
from .mesh import RowShards

__all__ = ["balance_slots", "greedy_pca_mesh"]


def balance_slots(sizes, sp, slots_per_device):
    """Assign areas to slot positions so per-device work balances.

    Device ``d`` runs slots ``[d*m, (d+1)*m)``.  Dealing areas in label
    order piles adjacent large areas onto one device; here the areas go
    largest-first to the least-loaded device (LPT scheduling, pixel count
    as the cost proxy).

    Returns ``slot_of_area``: area index (0-based) -> slot position.
    """
    order = np.argsort(sizes)[::-1]  # largest first
    load = np.zeros(sp, dtype=np.int64)
    used = np.zeros(sp, dtype=np.int64)
    slot_of_area = np.zeros(len(sizes), dtype=np.int64)
    for a in order:
        open_devs = np.nonzero(used < slots_per_device)[0]
        d = open_devs[np.argmin(load[open_devs])]
        slot_of_area[a] = d * slots_per_device + used[d]
        used[d] += 1
        load[d] += sizes[a]
    return slot_of_area


def greedy_pca_mesh(mesh, cube_std, areamap, thresholds, testO2,
                    noise_population=50.0, itermax=100):
    """Run the greedy PCA of every area over the mesh's slots.

    Parameters as ``TorchEngine.greedy_pca_by_area``: ``cube_std`` the
    (Nz, Ny, Nx) :class:`~.mesh.RowShards`, ``areamap`` a host (Ny, Nx)
    label map, ``thresholds`` / ``testO2`` the per-area O2 thresholds and
    test vectors.  Returns ``(cube_faint RowShards, mapO2 host int32
    image, nstop int)``.
    """
    sp = mesh.shape["sp"]
    devices = mesh.row(0)
    areamap = np.asarray(areamap)
    spatial_shape = areamap.shape
    nz = cube_std.shape[0]
    npix_loc = cube_std.ny_loc * spatial_shape[1]
    nb_area = int(areamap.max())
    sels = [np.flatnonzero((areamap == a).ravel())
            for a in range(1, nb_area + 1)]
    flat_in = [s.reshape(nz, -1) for s in cube_std.shards]
    flat_out = [f.clone() for f in flat_in]
    mapO2 = np.zeros(spatial_shape, dtype=np.int32)
    if not any(len(s) for s in sels):
        return RowShards(f.reshape(s.shape) for f, s in
                         zip(flat_out, cube_std.shards)), mapO2, 0
    per_device = -(-nb_area // sp)
    slot_of_area = balance_slots([len(s) for s in sels], sp, per_device)
    nstop = 0
    for a in np.argsort(slot_of_area, kind="stable"):
        sel = sels[a]
        if sel.size == 0:
            continue
        dev = devices[slot_of_area[a] // per_device]
        # the area's columns, shard by shard, in its (ascending) flat order
        tile = sel // npix_loc
        bounds = np.searchsorted(tile, np.arange(len(flat_in) + 1))
        parts = [(i, sel[bounds[i]:bounds[i + 1]] - i * npix_loc)
                 for i in range(len(flat_in)) if bounds[i + 1] > bounds[i]]
        cols = torch.cat([flat_in[i][:, torch.as_tensor(
            loc, device=flat_in[i].device)].to(dev) for i, loc in parts],
            dim=1)
        faint, m, k = greedy_pca(
            cols, torch.ones(sel.size, dtype=torch.bool, device=dev),
            torch.as_tensor(np.asarray(testO2[a], np.float32), device=dev),
            float(thresholds[a]), noise_population=float(noise_population),
            itermax=int(itermax))
        start = 0
        for i, loc in parts:
            out = flat_out[i]
            out[:, torch.as_tensor(loc, device=out.device)] = (
                faint[:, start:start + loc.size].to(out.device))
            start += loc.size
        mapO2.ravel()[sel] = m.cpu().numpy()
        nstop += int(k)
    return (RowShards(f.reshape(s.shape) for f, s in
                      zip(flat_out, cube_std.shards)), mapO2, nstop)
