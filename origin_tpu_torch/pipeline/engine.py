"""Device-resident execution engine for the detection front end.

Torch port of the main-path subset of
:class:`origin_tpu.pipeline.engine.DeviceEngine`: steps 01 (DCT +
standardization + local extrema), 04 (greedy PCA per area), 05 (GLR
matched filter), 07 (detection extraction), 08 (the detections'
minicubes), 09 (cube standard deviations) and 11 (the sources' spectra)
keep every cube-sized intermediate on the session's device, and only 2-D
images, per-area vectors, (50,)-vectors, sparse detection lists and
per-line and per-source results come back to the host.

Steps 01 and 04 also bring their products' recipe payloads to the host
(the DCT coefficients and channel means, the greedy PCA's rank-1 factors),
which the session stores in place of the dense cubes (``recipes.py``).

The raw cube and variance reach the device as the JAX engine's do, behind
the host work of the session's init: streamed slab by slab while the FITS
file decodes (:meth:`TorchEngine.stream_inputs`, ``ingest.py``), or copied
right after an eager read (:meth:`TorchEngine.prefetch_inputs`).  On CUDA
the copies are staged through a ring of page-locked slab buffers
(:class:`_SlabRing`) and run on a copy stream of their own; step 01 joins
them.  Float32 data is also reduced behind its copies, for the session's
white image and the host cube's non-finite pattern
(:meth:`TorchEngine.staged_white`).  The JAX engine's other transfer
machinery (int16 and bit-packed wires, speculative and bucketed
compaction) exists for a slow TPU host link and is not ported.

A field whose working set (:attr:`TorchEngine.HEADROOM_CUBES` cubes) does
not fit the device's memory budget (:func:`device_memory_fits`) runs in
the tight-memory mode, as in the JAX engine: the raw inputs leave the
device after step 01, finished products leave it after steps 01, 04 and
05 (:meth:`TorchEngine.maybe_offload`), step 05's spatial stage runs in
spectral slabs (:func:`~origin_tpu_torch.ops.glr.glr_spatial_chunked`),
step 08 cuts its windows on the host and step 11 builds its sources on
the host path.
"""

from __future__ import annotations

import contextlib
import functools
import logging
import os
import threading

import numpy as np
import torch

from .. import tracing
from ..core.containers import Cube
from ..device import resolve_device, set_precision
from ..ops.convolve import fft2_shape
from ..ops.dct import dct_residual
from ..ops.glr import (
    glr_spatial_chunked,
    glr_spatial_matmul,
    pack_profiles_toeplitz,
    prepare_profiles,
    spatial_operands,
)
from ..ops.lines import gather_windows
from ..ops.localmax import compute_local_max
from ..ops.pca import greedy_pca_areas
from ..ops.spatial import spatial_fsf, spatial_kernel_admits
from ..ops.spectra import batched_source_spectra
from ..ops.stats import o2test, standardize
from ..ops.sweep import spectral_sweep
from ..parallel.mesh import (
    RowShards, build_tile_spatial_op, glr_tile, preprocess_rows, std_rows,
    windowed)
from ..parallel.pca import greedy_pca_mesh
from . import ingest
from .products import Parked, TensorCube
from .recipes import recipes_enabled

__all__ = ["MeshEngine", "TorchEngine", "device_memory_budget",
           "device_memory_fits"]

log = logging.getLogger(__name__)


def device_memory_budget(device):
    """``(bytes, source)`` of the memory budget of ``device``; ``bytes`` is
    None where there is no limit.

    In this order: ``ORIGIN_TPU_HBM_BYTES`` (scientific notation
    accepted); on a CUDA device, the total that ``torch.cuda.mem_get_info``
    reports; the CPU has no limit.  Nothing is allocated to probe.
    """
    env = os.environ.get("ORIGIN_TPU_HBM_BYTES")
    if env:
        return int(float(env)), "ORIGIN_TPU_HBM_BYTES"
    device = torch.device(device)
    if device.type == "cuda":
        return (int(torch.cuda.mem_get_info(device)[1]),
                "torch.cuda.mem_get_info")
    return None, "host memory"


def device_memory_fits(nbytes, device):
    """Whether ``nbytes`` of working set fit the budget of ``device``
    (:func:`device_memory_budget`)."""
    budget, _ = device_memory_budget(device)
    return budget is None or nbytes <= budget


def _fill_cube(raw, mask):
    """The zero-filled cube (the host ``filled(0)`` view) on device."""
    return torch.where(mask, 0.0, raw)


def _fill_var(var_raw, mask):
    """The inf-filled variance (the host ``var_filled`` view) on device."""
    return torch.where(mask | ~torch.isfinite(var_raw), float("inf"),
                       var_raw)


class _SlabRing:
    """A ring of host slab buffers through which host arrays are copied to
    a device.

    On CUDA the buffers are page-locked: a ``non_blocking`` copy from
    pageable memory would be synchronous and serialize the copies behind
    the decode again.  A buffer is refilled only once the event recorded
    behind its last copy has completed.  One ring per process
    (:func:`_slab_ring`), reused by every session.
    """

    SLOTS = 3

    def __init__(self, nbytes, pinned):
        n = max(1, nbytes // 4)
        self.bufs = [torch.empty(n, dtype=torch.float32, pin_memory=pinned)
                     for _ in range(self.SLOTS)]
        self.events = [None] * self.SLOTS
        self.slot = 0
        self.lock = threading.Lock()

    def copy(self, dst, src, stream):
        """Copy the host array ``src`` (any real dtype, cast to float32)
        into the contiguous float32 tensor ``dst`` of its size, a buffer's
        worth at a time; on CUDA asynchronously on ``stream``."""
        dst = dst.view(-1)
        src = torch.from_numpy(np.ascontiguousarray(src).reshape(-1))
        if src.numel() != dst.numel():
            raise ValueError(f"slab of {src.numel()} values for "
                             f"{dst.numel()}")
        step = self.bufs[0].numel()
        with self.lock:
            for off in range(0, src.numel(), step):
                n = min(step, src.numel() - off)
                slot, self.slot = self.slot, (self.slot + 1) % self.SLOTS
                if self.events[slot] is not None:
                    self.events[slot].synchronize()  # its last copy ran
                buf = self.bufs[slot][:n]
                buf.copy_(src[off:off + n])
                if stream is None:
                    dst[off:off + n].copy_(buf)
                    continue
                with torch.cuda.stream(stream):
                    dst[off:off + n].copy_(buf, non_blocking=True)
                    self.events[slot] = torch.cuda.Event()
                    self.events[slot].record(stream)


_RINGS = {}
_RINGS_LOCK = threading.Lock()


def _slab_ring(pinned):
    """The process's :class:`_SlabRing` of ``ingest._SLAB_BYTES`` buffers,
    page-locked or not."""
    with _RINGS_LOCK:
        if pinned not in _RINGS:
            _RINGS[pinned] = _SlabRing(ingest._SLAB_BYTES, pinned)
        return _RINGS[pinned]


class _StagedInputs:
    """The raw cube and variance on their way to the device.

    Each is allocated once, at the field's shape, on the current stream,
    and filled in z order by :meth:`put` through the process's slab ring.
    On CUDA the copies run on a stream of their own, which first waits on
    the allocating stream; :meth:`join` makes the current stream wait on
    it.  On the CPU the same path copies synchronously.

    With ``white``, each data slab is also reduced on the device right
    behind its copy, on the same stream: the sum of each spaxel's finite
    values (float64) and their count (int32), from which the session's
    white image is taken (:meth:`white_sums`), and by which the host
    cube's non-finite pattern is copied back only where it is not empty
    (:meth:`nonfinite_mask`): the host cube is not scanned.
    """

    def __init__(self, device, shape, with_var, white=False):
        self.stream = None
        if device.type == "cuda":
            self.stream = torch.cuda.Stream(device)
        kinds = ("data", "var") if with_var else ("data",)
        self.raw = {k: torch.empty(shape, dtype=torch.float32, device=device)
                    for k in kinds}
        self.filled = dict.fromkeys(kinds, 0)
        self.white = white
        self._sums = self._white_host = None
        if white:
            npix = int(np.prod(shape[1:]))
            self._sums = (torch.zeros(npix, dtype=torch.float64,
                                      device=device),
                          torch.zeros(npix, dtype=torch.int32, device=device))
        if self.stream is not None:
            # after the allocating stream's work, the zero fills included
            self.stream.wait_stream(torch.cuda.current_stream(device))
            for t in (*self.raw.values(), *(self._sums or ())):
                # the allocator frees them only once their copies ran
                t.record_stream(self.stream)
        self.ring = _slab_ring(pinned=self.stream is not None)

    def put(self, kind, slab):
        """Copy the next z-slab of input ``kind`` (``"data"``, ``"var"``)."""
        z0 = self.filled[kind]
        z1 = z0 + len(slab)
        self.ring.copy(self.raw[kind][z0:z1], slab, self.stream)
        if kind == "data" and self._sums is not None:
            self._accumulate(self.raw["data"][z0:z1])
        self.filled[kind] = z1

    def _on_stream(self):
        """The copy stream made current (a no-op on the CPU)."""
        return (contextlib.nullcontext() if self.stream is None
                else torch.cuda.stream(self.stream))

    def _accumulate(self, planes):
        """Add the finite values of the (k, Ny, Nx) ``planes`` and their
        count into the spaxels' sums, on the copy stream.

        The pieces hold at most an eighth of a ring buffer's values, so
        that the float64 cast of one, with its reduction, takes no more
        than half a ring buffer's bytes, whatever the slab's size.
        """
        total, count = self._sums
        flat = planes.reshape(len(planes), -1)
        nz, npix = flat.shape
        budget = max(1, self.ring.bufs[0].numel() // 8)
        dz, dp = max(1, budget // npix), min(npix, budget)
        with self._on_stream():
            for z0 in range(0, nz, dz):
                for p0 in range(0, npix, dp):
                    piece = flat[z0:z0 + dz, p0:p0 + dp]
                    count[p0:p0 + dp] += torch.isfinite(piece).sum(
                        0, dtype=torch.int32)
                    total[p0:p0 + dp] += piece.double().nan_to_num_(
                        nan=0.0, posinf=0.0, neginf=0.0).sum(0)

    def nonfinite_mask(self):
        """The staged data's non-finite pattern: False where every
        spaxel's finite count (:meth:`white_sums`) is Nz, else the host
        bool array of the data's shape, copied back from the device in
        pieces of at most a ring buffer's values.  Counts the spaxels that
        hold a non-finite value (``ingest.flagged_spaxels``)."""
        _, count = self.white_sums()
        data = self.raw["data"]
        nz = data.shape[0]
        flagged = int((count < nz).sum())
        tracing.count("ingest.flagged_spaxels", flagged)
        if not flagged:
            return False
        out = np.empty(data.shape, bool)
        host = torch.from_numpy(out)
        dz = max(1, self.ring.bufs[0].numel() // count.size)
        with self._on_stream():
            for z0 in range(0, nz, dz):
                host[z0:z0 + dz].copy_(~torch.isfinite(data[z0:z0 + dz]))
        return out

    def white_sums(self):
        """``(sum, count)``: host (Ny, Nx) arrays of the sum of each
        spaxel's finite data values (float64) and their count (int32),
        fetched once; None without ``white``.  Waits for the copy
        stream's work queued so far."""
        if not self.white:
            return None
        if self._white_host is None:
            nz, ny, nx = self.raw["data"].shape
            if self.filled["data"] != nz:
                raise RuntimeError(f"staged data holds {self.filled['data']}"
                                   f" of {nz} planes")
            with self._on_stream():
                self._white_host = tuple(t.cpu().numpy().reshape(ny, nx)
                                         for t in self._sums)
            self._sums = None
        return self._white_host

    def join(self):
        """``{"data": tensor, "var": tensor or None}``, handed over once,
        with the current stream made to wait for their copies."""
        for kind, t in self.raw.items():
            if self.filled[kind] != t.shape[0]:
                raise RuntimeError(f"staged input {kind!r} holds "
                                   f"{self.filled[kind]} of {t.shape[0]} "
                                   "planes")
        if self.stream is not None:
            torch.cuda.current_stream(self.stream.device).wait_stream(
                self.stream)
        raw, self.raw = self.raw, {}
        return dict(data=raw["data"], var=raw.get("var"))

    def synchronize(self):
        """Wait until every copy queued so far has run."""
        if self.stream is not None:
            self.stream.synchronize()


def _host_windows(cube, ys, xs, sg, wmaps=None):
    """(b, Nz, sg, sg) data and variance windows (and (b, F, sg, sg) weight
    windows of the (F, Ny, Nx) ``wmaps``) centred at (ys, xs), cut from
    the raw host arrays of ``cube``.

    Each window is filled as the session's device inputs are: data 0 and
    variance inf at non-finite data (and at the cube's explicit mask), the
    variance inf where it is not finite, and data 0, variance inf and
    weight 0 outside the field: the values :func:`gather_windows` takes
    from the resident inputs (the JAX package's host cut).
    """
    raw = cube.data
    var = cube.var
    nl, ny, nx = raw.shape
    b = len(ys)
    dat = np.zeros((b, nl, sg, sg), np.float32)
    vr = np.full((b, nl, sg, sg), np.inf, np.float32)
    wgt = (None if wmaps is None
           else np.zeros((b, wmaps.shape[0], sg, sg), np.float32))
    h = sg // 2
    for j in range(b):
        yy0, xx0 = int(ys[j]) - h, int(xs[j]) - h
        sy = slice(max(0, yy0), min(ny, yy0 + sg))
        sx = slice(max(0, xx0), min(nx, xx0 + sg))
        win = (j, slice(None), slice(sy.start - yy0, sy.stop - yy0),
               slice(sx.start - xx0, sx.stop - xx0))
        d = np.asarray(raw[:, sy, sx], np.float32)
        v = (np.ones_like(d) if var is None
             else np.asarray(var[:, sy, sx], np.float32))
        bad = ~np.isfinite(d)
        if cube.mask is not None:
            bad |= np.asarray(cube.mask[:, sy, sx], bool)
        dat[win] = np.where(bad, 0.0, d)
        vr[win] = np.where(bad | ~np.isfinite(v), np.inf, v)
        if wgt is not None:
            wgt[win] = wmaps[:, sy, sx]
    return (dat, vr) if wgt is None else (dat, vr, wgt)


def _mask_extrema(correl, correl_min, profile, mask, size, prof_dtype=None):
    """Masking (in place) + 3-D local extrema + max/min maps."""
    correl.masked_fill_(mask, 0.0)
    correl_min.masked_fill_(mask, 0.0)
    profile.masked_fill_(mask, 0)
    lmax, lmin = compute_local_max(correl, correl_min, mask, size)
    minmap = torch.amin(correl_min, dim=0)
    if prof_dtype is not None:
        profile = profile.to(prof_dtype)
    return (correl, correl_min, profile, lmax, lmin,
            torch.amax(correl, dim=0), minmap)


def _host(t):
    return t.cpu().numpy()


def _profile_dtype(nprof):
    """dtype of the best-profile cube for ``nprof`` profiles: uint8 (the
    reference's in-memory dtype), int16, or None to keep the kernel's
    int32 indices."""
    if nprof <= np.iinfo(np.uint8).max:
        return torch.uint8
    if nprof <= np.iinfo(np.int16).max:
        return torch.int16
    return None


class TorchEngine:
    """Per-session holder of device-resident front-end state.

    ``device`` is explicit (``"cuda"`` or ``"cpu"``); constructing the
    engine sets the float32 precision contract (:func:`set_precision`) and,
    for a session with a cube, decides its memory mode
    (:attr:`tight_memory`).
    """

    #: cube-sized products are divided over this many devices
    memory_shards = 1
    #: cubes of the field demanded before running unchunked: ~10 resident
    #: cube-sized products plus step 05's spectra bank and transients
    HEADROOM_CUBES = 24

    def __init__(self, orig, device):
        self.orig = orig
        self.device = resolve_device(device)
        set_precision()
        self._inputs = {}
        self._staged = None
        self._host_cut = False
        self._tight = None
        if getattr(orig, "shape", None) is not None:
            _ = self.tight_memory  # one mode for every step of the session

    @property
    def tight_memory(self):
        """True when the device's budget cannot hold ``HEADROOM_CUBES``
        float32 cubes of the field (:func:`device_memory_fits`); decided
        once and logged with the budget."""
        if self._tight is None:
            need = (4 * int(np.prod(self.orig.shape)) * self.HEADROOM_CUBES
                    // self.memory_shards)
            budget, source = device_memory_budget(self.device)
            self._tight = budget is not None and need > budget
            log.info(
                "memory mode: %s (%d cubes of the field need %.3g GB; "
                "budget %s from %s)",
                "tight" if self._tight else "normal", self.HEADROOM_CUBES,
                need / 1e9,
                "none" if budget is None else f"{budget / 1e9:.3g} GB",
                source)
        return self._tight

    # -- inputs ------------------------------------------------------------
    @staticmethod
    def _kernel_precision():
        """Matmul precision of the GLR kernels (``_pallas_precision`` of
        the JAX engine): ``ORIGIN_TPU_PRECISION=bf16x3`` selects the
        3-pass bf16 scheme, and ``highest`` (the default) float32; any
        other value warns and means ``highest``."""
        mode = os.environ.get("ORIGIN_TPU_PRECISION", "highest").lower()
        if mode == "bf16x3":
            return "bf16x3"
        if mode not in ("highest", ""):
            logging.getLogger(__name__).warning(
                "unknown ORIGIN_TPU_PRECISION=%r (valid: highest, bf16x3); "
                "using highest", mode,
            )
        return "highest"

    def _upload(self, arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def resident(self, tensor):
        """A cube-sized tensor (on any device) where this engine keeps its
        cube products: on the session's device."""
        return tensor.to(self.device)

    def _upload_cube(self, arr):
        """A host cube where this engine keeps its cubes."""
        return self.resident(torch.from_numpy(np.ascontiguousarray(arr)))

    @staticmethod
    def _each(fn, *cubes):
        """``fn`` applied to the engine's cubes (tile by tile on a mesh)."""
        return fn(*cubes)

    @staticmethod
    def _image(cube, fn):
        """The host image ``fn(cube)`` for an ``fn`` that reduces over z
        (the tiles' images concatenated along y, on a mesh)."""
        return _host(fn(cube))

    def image_of(self, name, fn):
        """:meth:`_image` of cube product ``name`` (``o2test``)."""
        return self._image(self.get(name), fn)

    def stream_inputs(self, plan):
        """Decode the cube file of ``plan`` (an :class:`~.ingest.
        IngestPlan`) and copy its raw data and variance to the device, slab
        by slab while the decode runs (:class:`_StagedInputs`); returns the
        host :class:`Cube`.  Step 01 joins the copies
        (:meth:`_ensure_inputs`).  A float32 payload is also reduced on the
        device as it lands (:meth:`staged_white`), and the host cube's
        non-finite pattern comes from the device's copy
        (:meth:`_StagedInputs.nonfinite_mask`)."""
        white = plan.dtype == np.float32
        staged = self._staged = _StagedInputs(self.device, plan.shape,
                                              plan.has_var, white=white)
        return plan.read(upload_data=functools.partial(staged.put, "data"),
                         upload_var=functools.partial(staged.put, "var"),
                         nonfinite=staged.nonfinite_mask if white else None)

    def prefetch_inputs(self):
        """Start the copies of the session cube's raw data and variance to
        the device (:class:`_StagedInputs`), for a cube read eagerly, so
        that they run behind the rest of the session's init; step 01 joins
        them.  Nothing is done for inputs already staged or on the device,
        or for a cube whose mask is not its data's non-finite pattern
        (step 01 uploads its host views)."""
        c = self.orig.cube
        derived = (getattr(c, "_mask_is_nonfinite", False)
                   and c.mask is getattr(c, "_derived_mask", ()))
        if self._staged is not None or "cube" in self._inputs or (
                c.mask is not None and not derived):
            return
        staged = _StagedInputs(self.device, c.shape, c.var is not None,
                               white=c.data.dtype == np.float32)
        staged.put("data", c.data)
        if c.var is not None:
            staged.put("var", c.var)
        self._staged = staged

    def stages_white(self):
        """Whether the staged inputs reduce their data for the white image
        (:meth:`staged_white`)."""
        return self._staged is not None and self._staged.white

    def staged_white(self):
        """``(sum, count)`` of each spaxel's finite data values
        (:meth:`_StagedInputs.white_sums`) when the staged inputs reduced
        their float32 data as it landed; None otherwise (inputs not staged,
        or a float64 payload, whose float32 copy would change the
        reduction)."""
        staged = self._staged
        return None if staged is None else staged.white_sums()

    def _ensure_inputs(self, *names):
        """Put the inputs ``names`` that are not on the device there.

        Staged inputs (:meth:`stream_inputs`, :meth:`prefetch_inputs`) are
        joined, and the zero-filled cube, the inf-filled variance and the
        NaN mask derived from them on the device.  Otherwise a cube without
        a mask uploads its raw data and variance and derives the three the
        same way (from the resident mask when there is one), and a cube
        with a mask uploads the host views.
        """
        missing = [n for n in names if n not in self._inputs]
        if not missing:
            return
        orig, c = self.orig, self.orig.cube
        up, each = self._upload_cube, self._each
        staged, self._staged = self._staged, None
        if staged is not None:
            with tracing.span("preprocess.join"):
                raws = staged.join()
            missing = [n for n in ("cube", "var", "mask")
                       if n not in self._inputs]
        elif c.mask is not None:
            views = dict(cube=lambda: orig.cube_raw, var=lambda: orig.var,
                         mask=lambda: orig.mask)
            for n in missing:
                self._inputs[n] = up(views[n]())
            return

        def raw(kind):
            if staged is not None:
                return raws.pop(kind)
            arr = c.data if kind == "data" else c.var
            return None if arr is None else up(np.asarray(arr, np.float32))

        mask = self._inputs.get("mask")
        if "cube" in missing or mask is None:
            data = raw("data")
            if mask is None:
                mask = self._inputs["mask"] = each(
                    lambda r: ~torch.isfinite(r), data)
            if "cube" in missing:
                self._inputs["cube"] = each(_fill_cube, data, mask)
            del data
        if "var" in missing:
            var_raw = raw("var")
            if var_raw is None:
                var_raw = each(lambda m: torch.ones(
                    m.shape, dtype=torch.float32, device=m.device), mask)
            self._inputs["var"] = each(_fill_var, var_raw, mask)

    def input_cube(self):
        self._ensure_inputs("cube")
        return self._inputs["cube"]

    def input_var(self):
        self._ensure_inputs("var")
        return self._inputs["var"]

    def input_mask(self):
        self._ensure_inputs("mask")
        return self._inputs["mask"]

    def drop_inputs(self, *names):
        """Free the device copies of the inputs ``names``."""
        for n in names:
            self._inputs.pop(n, None)

    def inputs_resident(self):
        """Whether the raw cube is on the device; False once a tight-memory
        session dropped it after step 01, so that step 08 cuts its few
        windows on the host rather than upload the field again."""
        return "cube" in self._inputs

    def load_state(self, arrays):
        """Start the session mid-pipeline from the JAX package's state.

        ``arrays`` (numpy) is converted by
        :func:`origin_tpu_torch.convert.state_from_numpy`.  Step products
        (``cube_std``, ``cube_faint``, ``areamap``, ...) are published in
        their steps, which then count as run; ``testO2`` and the
        thresholds (``threshold``, ``threshold_std``, ``nbareas``) go to
        the session.  The step-05 constants (Toeplitz banks, DFT factors,
        FSF cubes) are not state: :meth:`tglr` derives them from the
        session's profiles and FSF with the JAX package's own numpy code.
        """
        from ..convert import state_from_numpy
        from .steps import Status

        orig = self.orig
        owners = orig._product_owner
        # on the host first: a cube goes where the engine keeps its cubes
        # (``store_cube_dev`` through :meth:`resident`)
        for name, val in state_from_numpy(arrays, "cpu").items():
            owner = owners.get(name)
            if owner is not None:
                kind = owner.products[name]
                if kind == "cube":
                    owner.store_cube_dev(name, val)
                elif kind == "image":
                    owner.store_image(name, _host(val))
                else:
                    owner.put(name, _host(val))
                owner.status = Status.RUN
            elif name == "testO2":
                orig.testO2 = [_host(v) for v in val]
            elif name in ("threshold", "threshold_std", "nbareas"):
                orig.param[name] = val
            else:
                raise KeyError(f"load_state: unknown state {name!r}")

    def _peek(self, name):
        """The session's object of product ``name`` as it is (None if
        absent)."""
        owner = self.orig._product_owner.get(name)
        return owner.store.peek(name) if owner is not None else None

    def _product(self, name):
        """:meth:`_peek`, a parked product read (and uploaded) first."""
        obj = self._peek(name)
        if isinstance(obj, Parked):
            obj = self.orig._product_owner[name].store.fetch(name)
        return obj

    def get(self, name):
        """Device tensor of a cube-sized session product.  A product that
        a tight-memory session moved to the host (:meth:`offload`) is
        uploaded for the caller and stays on the host."""
        obj = self._product(name)
        if isinstance(obj, TensorCube):
            return self.resident(obj.tensor)
        if isinstance(obj, Cube):
            return self._upload_cube(np.asarray(obj.data, np.float32))
        raise KeyError(f"no cube product {name!r} in this session")

    def on_device(self, name):
        """Whether cube product ``name`` holds the session device's memory
        (False once :meth:`offload` moved it to the host)."""
        obj = self._peek(name)
        return isinstance(obj, TensorCube) and not obj.offloaded

    #: offloaded products whose standard deviation step 09 reads: it is
    #: taken on the device at the offload (:meth:`std_scalar`)
    _STD_CACHED = ("cube_std",)

    def offload(self, *names):
        """Move finished cube products off the device, freeing its memory.

        A product stored as a recipe (``cube_std``, ``cont_dct``,
        ``cube_faint`` of a session read from a file, recipes on) becomes
        its :class:`~.recipes.LazyRecipeCube`, rebuilt on the host at its
        first read and written as the same recipe file; any other becomes
        a host copy (:meth:`TensorCube.to_host`), written in its form.
        The standard deviation of a detection statistic is taken on the
        device first.  :meth:`get` uploads either again for a device step.
        """
        for name in names:
            obj = self._peek(name)
            if not isinstance(obj, TensorCube) or obj.offloaded:
                continue
            std = self._std(obj.tensor) if name in self._STD_CACHED else None
            if obj.recipe is not None and recipes_enabled():
                host = obj.recipe.lazy_cube(self.orig)
                host._recipe_source = obj._recipe_source
                self.orig._product_owner[name].store.stash(name, host)
            else:
                host = obj
                obj.to_host()
            if std is not None:
                host._std_scalar = std

    def maybe_offload(self, *names):
        """:meth:`offload` on a tight-memory session; nothing otherwise."""
        if self.tight_memory:
            self.offload(*names)

    def release(self):
        """Drop every device allocation this session's engine holds.

        A process that runs several fields (the CLI's survey mode) calls
        this once a field is finished (everything parked) or abandoned
        after a failure: the engine's input tensors go, and so does every
        live cube product (:meth:`ProductStore.release`: one read back
        from its session file points at it again, one never written loses
        its content).  Copies of staged inputs still queued are waited for
        first, so that none writes into freed memory.  On a CUDA device the
        allocator's cached blocks are then returned, so the next field
        starts with the card's memory.
        """
        with tracing.span("engine.release",
                          field=getattr(self.orig, "trace_field", None)):
            if self._staged is not None:
                self._staged.synchronize()
                self._staged = None
            self._inputs.clear()
            for step in self.orig.steps.values():
                step.store.release(self.orig.outpath)
            if self.device.type == "cuda":
                torch.cuda.empty_cache()

    # -- step 01 -----------------------------------------------------------
    def preprocess(self, dct_order=10, dct_approx=False, local_max_size=3):
        """DCT + standardization + std local extrema.

        Returns (device dict, host dict): the cube-sized products stay on
        device; the 2-D images come back as numpy, with the recipe payload
        of cube_std and cont_dct: the (order+1, Ny, Nx) DCT coefficients
        ``coef`` and the (Nz,) channel means ``mean_z``.  A tight-memory
        session then drops the raw cube and variance from the device.
        """
        data, cont_std, coef, mean_z, lmax, lmin = self._preprocess(
            dct_order, dct_approx, local_max_size)
        img = self._image
        host = dict(
            ima_std=img(data, lambda t: torch.mean(t, dim=0)),
            ima_dct=img(cont_std, lambda t: torch.mean(t, dim=0)),
            o2=img(data, o2test),
            cont_sumsq=img(cont_std, lambda t: torch.sum(t * t, dim=0)),
            coef=img(coef, lambda t: t), mean_z=_host(mean_z),
        )
        dev = dict(cube_std=data, cont_dct=cont_std,
                   cube_std_local_max=lmax, cube_std_local_min=lmin)
        if self.tight_memory:
            # step 08 cuts its windows on the host; the mask stays for 05
            self.drop_inputs("cube", "var")
        return dev, host

    def _preprocess(self, dct_order, dct_approx, local_max_size):
        """Step 01's device math: ``(cube_std, cont_dct, coef, mean_z,
        local_max, local_min)``."""
        cube, var, mask = (self.input_cube(), self.input_var(),
                           self.input_mask())
        cont, coef = dct_residual(cube, dct_order, var=var,
                                  approx=dct_approx, mask=mask,
                                  with_coef=True)
        data, cont_std, mean_z = standardize(cube, cont, var, mask,
                                             with_mean=True)
        del cont
        lmax, lmin = compute_local_max(data, data, mask, local_max_size)
        return data, cont_std, coef, mean_z, lmax, lmin

    # -- step 04 -----------------------------------------------------------
    def greedy_pca_by_area(self, areamap, thresholds, testO2,
                           noise_population=50.0, itermax=100):
        """Zone-wise greedy PCA with device-resident gather/scatter.

        :func:`greedy_pca_areas` on a copy of ``cube_std``: per area, the
        (Nz, Npix_area) column block is gathered on device, cleaned by
        :func:`greedy_pca` and scattered back.  Returns ``(faint, mapO2, nstop, factors)``, where
        ``factors`` is the cube_faint recipe's payload: per area, its flat
        spatial indices and the rank-1 factors ``(U, C)`` that
        :func:`greedy_pca` removed, trimmed to the used columns as the JAX
        engine trims them.
        """
        cube_std = self.get("cube_std")
        flat = cube_std.reshape(cube_std.shape[0], -1).clone()
        mapO2, nstop, factors = greedy_pca_areas(
            flat, areamap, thresholds, testO2,
            noise_population=noise_population, itermax=itermax,
            record_factors=True)
        return flat.reshape(cube_std.shape), mapO2, nstop, factors

    # -- step 05 -----------------------------------------------------------
    def tglr(self, psf, wfields, profiles, pcut=1e-8, pmeansub=True, size=3):
        """GLR matched filter + local extrema, all device-resident.

        Instrument-model precompute (FSF spectra + norm cube), spatial FSF
        stage, the spectral sweep (:func:`spectral_sweep`: the CUDA kernel
        on a GPU) at the session's precision (:meth:`_kernel_precision`),
        masking, local extrema and the max/min maps.  A tight-memory
        session runs the spatial stage in spectral slabs
        (:func:`glr_spatial_chunked`) instead of holding the spectra bank,
        as the JAX engine does.  Counts the fields (``glr.fields``) and the
        bank's bytes (``glr.bank_bytes``, 0 when tight) once a call.
        Returns (device dict, host dict with the maxmap/minmap images).
        """
        faint = self.get("cube_faint")
        nz, ny, nx = faint.shape
        if wfields is None:
            psfs = np.asarray(psf, dtype=np.float32)
            if psfs.ndim == 3:
                psfs = psfs[None]
            wmaps = None
        else:
            psfs = np.stack([np.asarray(p, np.float32) for p in psf])
            wmaps = self._upload(
                np.stack([np.asarray(w, np.float32) for w in wfields]))
        fshape2 = fft2_shape((ny, nx), psfs.shape[-2:])
        prepped = prepare_profiles(profiles, pcut=pcut, pmeansub=pmeansub)
        t_num, t_den, pad_left, _ = pack_profiles_toeplitz(
            prepped, block=min(128, nz))
        prof_dtype = _profile_dtype(len(prepped))
        prec = self._kernel_precision()
        tracing.count("glr.fields", psfs.shape[0])
        if self.tight_memory:
            tracing.count("glr.bank_bytes", 0)  # no spectra bank is held
            cube_fsf, norm_fsf = glr_spatial_chunked(
                faint, self._upload(psfs), wmaps, fshape2)
        else:
            cube_fsf, norm_fsf = self._spatial(faint, psfs, wmaps, fshape2,
                                               prec)
        del faint
        correl, profile, correl_min = spectral_sweep(
            cube_fsf.contiguous(), norm_fsf, self._upload(t_num),
            self._upload(t_den), pad_left, nz, precision=prec)
        del cube_fsf, norm_fsf
        (correl, correl_min, profile, lmax, lmin, maxmap,
         minmap) = _mask_extrema(correl, correl_min, profile,
                                 self.input_mask(), size,
                                 prof_dtype=prof_dtype)
        dev = dict(cube_correl=correl, cube_correl_min=correl_min,
                   cube_profile=profile, cube_local_max=lmax,
                   cube_local_min=lmin)
        return dev, dict(maxmap=_host(maxmap), minmap=_host(minmap))

    def _spatial(self, faint, psfs, wmaps, fshape2, prec):
        """Step 05's spatial stage on the whole cube: (cube_fsf,
        norm_fsf) from the precomputed FSF spectra bank."""
        ny, nx = faint.shape[1:]
        kern_r, kern_i, factors, norm_fsf = spatial_operands(
            self._upload(psfs), wmaps, ny, nx, fshape2)
        tracing.count("glr.bank_bytes", kern_r.nbytes + kern_i.nbytes)
        # the JAX engine's route (engine.py:1025-1032): the fused spatial
        # kernel only in bf16x3 and only on a field it admits, else the
        # float32 matmul chain (XLA there, cuBLAS here); not a fallback
        if prec == "bf16x3" and spatial_kernel_admits(
                ny, nx, fshape2[0], fshape2[1] // 2 + 1):
            cube_fsf = spatial_fsf(faint.contiguous(), kern_r, kern_i, wmaps,
                                   factors, precision=prec)
        else:
            cube_fsf = glr_spatial_matmul(faint, kern_r, kern_i, wmaps,
                                          factors)
        return cube_fsf, norm_fsf

    # -- step 07 -----------------------------------------------------------
    def detections_above(self, name, threshold, gather=()):
        """Sparse (z, y, x) coordinates where ``name`` exceeds threshold.

        ``torch.nonzero`` returns the row-major (z, y, x) order of
        ``np.where``.  Returns ``((z, y, x), values, [gathered values])``
        as numpy arrays.
        """
        arr = self.get(name)
        thr = torch.tensor(threshold, dtype=arr.dtype, device=arr.device)
        idx = torch.nonzero(arr > thr)
        z, y, x = idx.unbind(1)
        vals = arr[z, y, x]
        extras = [self.get(g)[z, y, x] for g in gather]
        zyx = tuple(_host(a) for a in (z, y, x))
        return zyx, _host(vals), [_host(e) for e in extras]

    # -- step 08 -----------------------------------------------------------
    @contextlib.contextmanager
    def cutting_windows(self, n, sg):
        """Step 08's cut of ``n`` windows of edge ``sg`` by
        :meth:`minicubes` inside the block.

        When the inputs left the device (a tight-memory session after step
        01) and the windows hold fewer spaxels than the field
        (``n * sg**2 < Ny * Nx``), they are cut from the session cube's
        host arrays and only they are uploaded; otherwise they are gathered
        from the inputs, uploaded again if need be and, on a tight-memory
        session, dropped after the block (no later step reads them).
        """
        ny, nx = self.orig.shape[1:]
        self._host_cut = (not self.inputs_resident()
                          and n * sg * sg < ny * nx)
        try:
            yield
        finally:
            host, self._host_cut = self._host_cut, False
            if not host and self.tight_memory:
                self.drop_inputs("cube", "var")

    def minicubes(self, xs, ys, sg, wmaps=None):
        """(B, Nz, sg, sg) detection minicubes on device.

        One index gather from the resident zero-filled cube and
        inf-filled variance (:func:`gather_windows`), out-of-field cells
        filled with data 0 and variance inf, at any field size; with the
        (F, Ny, Nx) tensor ``wmaps``, also the (B, F, sg, sg) weight
        windows, filled with 0.  Inside :meth:`cutting_windows`'s host cut
        the same windows come from :func:`_host_windows`.  Returns the
        tuple of windows.
        """
        if self._host_cut:
            host = _host_windows(
                self.orig.cube, torch.as_tensor(ys).cpu().numpy(),
                torch.as_tensor(xs).cpu().numpy(), sg,
                None if wmaps is None else torch.as_tensor(wmaps).cpu()
                .numpy())
            return tuple(self._upload(w) for w in host)
        ys = torch.as_tensor(ys, dtype=torch.int64, device=self.device)
        xs = torch.as_tensor(xs, dtype=torch.int64, device=self.device)
        h = sg // 2

        def cut(arr, fill):
            return windowed(
                lambda c, y, x: gather_windows(c, y + h, x, sg, fill),
                arr, ys - h, sg, xs)

        out = (cut(self.input_cube(), 0.0), cut(self.input_var(),
                                                  float("inf")))
        if wmaps is not None:
            wmaps = torch.as_tensor(wmaps, device=self.device)
            out += (gather_windows(wmaps, ys, xs, sg, 0.0),)
        return out

    # -- step 09 -----------------------------------------------------------
    @staticmethod
    def _std(t):
        """Population standard deviation (``jnp.std``; torch's default
        ``correction=1`` would be the sample one): :func:`std_rows`."""
        return std_rows(t)

    def std_scalar(self, name):
        """Standard deviation of a cube product: the value taken on the
        device when the product was offloaded, else that of its device
        tensor (the same reduction)."""
        cached = getattr(self._product(name), "_std_scalar", None)
        if cached is not None:
            return cached
        return self._std(self.get(name))

    # -- step 11 -----------------------------------------------------------
    def source_spectra(self, jobs_by_size, wcube_fn=None):
        """Batched device extraction of every source's spectra.

        ``jobs_by_size`` maps ``(m, fsf)``, a cutout edge and a key of
        the sources' FSF, to a list of job dicts (see
        :func:`origin_tpu_torch.ops.spectra.batched_source_spectra`) whose
        ``y0``/``x0`` are window starts in FIELD coordinates (possibly
        negative near the border).  ``wcube_fn(m, fsf)`` returns the
        (Nz, m, m) PSF weight cube of that size and FSF.  The windows
        are gathered from the resident inputs, cells outside the field
        filled as the JAX engine's padded copies are.

        Returns ``{source_id: {tag: spectrum}}``, or ``{}`` on a
        tight-memory session, whose inputs left the device: step 11 then
        takes the host path.
        """
        if self.tight_memory:
            return {}
        inputs = (self.input_cube(), self.input_var(), self.input_mask())
        out = {}
        for (m, fsf), jobs in jobs_by_size.items():
            wcube = wcube_fn(m, fsf) if wcube_fn is not None else None

            def spectra(cubes, y0, group):
                return batched_source_spectra(
                    *cubes, [dict(j, y0=int(y)) for j, y in zip(group, y0)],
                    wcube)

            out.update(windowed(spectra, inputs,
                                np.asarray([j["y0"] for j in jobs]), m,
                                np.asarray(jobs, dtype=object)))
        return out


class MeshEngine(TorchEngine):
    """:class:`TorchEngine` over a ``(1 x sp)`` :class:`~origin_tpu_torch.
    parallel.mesh.Mesh`.

    The interface is :class:`TorchEngine`'s, so the steps run unchanged;
    the inputs and every cube product live as :class:`~origin_tpu_torch.
    parallel.mesh.RowShards` over the mesh's ``sp`` slots, never whole on
    one device, and the steps' device math distributes as in the JAX
    package's ``MeshEngine``:

    - step 01: per tile the DCT residual and standardization, the channel
      means summed over the tiles, the local extrema with ``size//2``
      halo rows (:func:`~origin_tpu_torch.parallel.mesh.preprocess_rows`;
      the JAX package leaves this step to XLA's partitioner);
    - step 04: the areas dealt onto the slots, each gathered from the
      shards onto its slot's device (:func:`~origin_tpu_torch.parallel.
      pca.greedy_pca_mesh`); the mesh path records no rank-1 factors, so
      ``cube_faint`` is written dense, as the JAX mesh session writes it;
    - step 05: the tiles' spatial stage with FSF halo exchange and one
      sweep launch per tile (:func:`~origin_tpu_torch.parallel.mesh.
      glr_tile`), mosaics included;
    - steps 06-11: the purity counts summed tile by tile, the detections
      found per tile and put in the single device's (z, y, x) order, and
      every window cut from the one or two tiles that hold its rows
      (:func:`~origin_tpu_torch.parallel.mesh.windowed`).

    A slot may name the same device as another, so ``sp`` shards can all
    run on one card.  :attr:`memory_shards` counts the mesh's distinct
    devices (the JAX engine uses ``sp``): shards on one card do not divide
    its memory.
    """

    def __init__(self, orig, mesh, device=None):
        if "sp" not in mesh.shape:
            raise ValueError("session mesh needs an 'sp' axis "
                             "(make_mesh(n, dp=1))")
        extra = {k: v for k, v in mesh.shape.items()
                 if k != "sp" and v != 1}
        if extra:
            raise ValueError(
                f"session mesh must be (1 x sp), got extra axes {extra}; "
                "a session processes one cube — use sharded_detect_batch "
                "for dp batches of cubes"
            )
        ny = orig.shape[1]
        self.sp = mesh.shape["sp"]
        if ny % self.sp != 0:
            raise ValueError(
                f"Ny={ny} must divide evenly over sp={self.sp} row shards"
            )
        self.slots = mesh.row(0)
        if device is not None:
            want = resolve_device(device)
            wrong = [str(d) for d in self.slots
                     if d.type != want.type
                     or want.index not in (None, d.index)]
            if wrong:
                raise ValueError(
                    f"mesh slots {wrong} are not on the session's device "
                    f"{str(want)!r}")
        self.mesh = mesh
        # set before the parent's init, which decides the memory mode
        self.memory_shards = len(mesh.distinct)
        super().__init__(orig, self.slots[0])

    # -- where the cubes live ------------------------------------------------
    def resident(self, tensor):
        if isinstance(tensor, RowShards):
            return tensor
        return RowShards.split(tensor, self.slots)

    @staticmethod
    def _each(fn, *cubes):
        return cubes[0].map(fn, *cubes[1:])

    @staticmethod
    def _image(cube, fn):
        return _host(cube.image(fn))

    # -- step 01 -------------------------------------------------------------
    def _preprocess(self, dct_order, dct_approx, local_max_size):
        return preprocess_rows(self.input_cube(), self.input_var(),
                               self.input_mask(), dct_order, dct_approx,
                               local_max_size)

    # -- step 04 -------------------------------------------------------------
    def greedy_pca_by_area(self, areamap, thresholds, testO2,
                           noise_population=50.0, itermax=100):
        """Area-parallel greedy PCA over the mesh; no recipe factors (the
        JAX mesh path keeps the dense fetch)."""
        faint, mapO2, nstop = greedy_pca_mesh(
            self.mesh, self.get("cube_std"), areamap, thresholds, testO2,
            noise_population=noise_population, itermax=itermax)
        return faint, mapO2, nstop, None

    # -- step 05 -------------------------------------------------------------
    def tglr(self, psf, wfields, profiles, pcut=1e-8, pmeansub=True, size=3):
        """Row-sharded GLR matched filter and local extrema
        (:func:`glr_tile`), the sweep at the session's precision."""
        faint = self.get("cube_faint")
        nz, ny, nx = faint.shape
        if wfields is None:
            psfs = np.asarray(psf, dtype=np.float32)
            fields = [psfs[0] if psfs.ndim == 4 else psfs]
            wtiles = None
        else:
            fields = [np.asarray(p, np.float32) for p in psf]
            wtiles = self._upload_cube(
                np.stack([np.asarray(w, np.float32) for w in wfields]))
        halo = max((f.shape[-2] - 1) // 2 for f in fields)
        ops = [build_tile_spatial_op(f, ny // self.sp, nx, halo,
                                     device=self.device)[0]
               for f in fields]
        prepped = prepare_profiles(profiles, pcut=pcut, pmeansub=pmeansub)
        t_num, t_den, pad_left, _ = pack_profiles_toeplitz(
            prepped, block=min(128, nz))
        (correl, correl_min, profile, lmax, lmin, maxmap,
         minmap) = glr_tile(faint, self.input_mask(), ops, t_num, t_den,
                            pad_left, nz, local_max_size=size, halo=halo,
                            wtiles=wtiles,
                            precision=self._kernel_precision(),
                            prof_dtype=_profile_dtype(len(prepped)))
        dev = dict(cube_correl=correl, cube_correl_min=correl_min,
                   cube_profile=profile, cube_local_max=lmax,
                   cube_local_min=lmin)
        return dev, dict(maxmap=maxmap.to_host(), minmap=minmap.to_host())

    # -- step 07 -------------------------------------------------------------
    def detections_above(self, name, threshold, gather=()):
        """The tiles' detections, rows offset to the cube's and sorted
        into the single device's row-major (z, y, x) order."""
        arr = self.get(name)
        extras = [self.get(g) for g in gather]
        zyx, vals, ex = ([], [], []), [], [[] for _ in gather]
        for i, t in enumerate(arr.shards):
            thr = torch.tensor(threshold, dtype=t.dtype, device=t.device)
            z, y, x = torch.nonzero(t > thr).unbind(1)
            vals.append(_host(t[z, y, x]))
            for k, e in enumerate(extras):
                ex[k].append(_host(e.shards[i][z, y, x]))
            for k, a in enumerate((z, y + arr.row_start(i), x)):
                zyx[k].append(_host(a))
        z, y, x = (np.concatenate(a) for a in zyx)
        ny, nx = arr.shape[1:]
        order = np.argsort((z * ny + y) * nx + x, kind="stable")
        return ((z[order], y[order], x[order]),
                np.concatenate(vals)[order],
                [np.concatenate(e)[order] for e in ex])
