"""Row-sharded detection over a mesh of torch devices.

Torch port of :mod:`origin_tpu.parallel.mesh`.  A :class:`Mesh` is a
``(dp, sp)`` grid of ``torch.device``\\ s, and a slot may name the same
device as another (``["cuda:0"] * 4``, ``["cpu"] * 8``), so the sharded
math runs on one card or in the CPU tests as it would on several:

- axis ``dp`` takes independent cubes (mosaic fields);
- axis ``sp`` takes the Y rows of a cube: a cube-sized product lives as
  :class:`RowShards`, one ``(..., Ny/sp, Nx)`` tensor per slot on that
  slot's device, and is never assembled whole on one device.  The
  operators that reach across rows take ``halo`` rows from the
  neighbouring tiles (:func:`halo_exchange_rows`: the FSF's y extent for
  the spatial stage, ``size//2`` for the local-max filter); channel means
  and detection counts are sums of the tiles' partial sums, in slot
  order.

The JAX package runs the tiles inside one ``shard_map`` program with
``ppermute`` halos and ``psum`` reductions; here one process walks the
slots in order and a neighbour's rows are ``.to(device)`` copies.  Each
tile's spatial stage uses its own (halo-extended) DFT grid, so the
results agree with a single device's to float32 round-off, not bit for
bit, as in the JAX package: the tests hold the local extrema at atol 2e-3
/ rtol 1e-3 and the counts at scanned thresholds within 2 voxels.

The per-tile spectral sweep is :func:`~origin_tpu_torch.ops.sweep.
spectral_sweep`: the CUDA kernel on a CUDA tile, its plain version on a
CPU tile.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ops.dct import dct_residual
from ..ops.glr import (
    dft_spatial_factors, glr_spatial_matmul, pack_profiles_toeplitz,
    prepare_profiles,
)
from ..ops.localmax import _maxfilter
from ..ops.purity import counts_above_thresholds
from ..ops.quant import abs_max, encode_i16, i16_scale, quantize_pairs
from ..ops.stats import standardize
from ..ops.sweep import spectral_sweep

__all__ = [
    "Mesh",
    "RowShards",
    "ShardedPipeline",
    "build_tile_spatial_op",
    "glr_tile",
    "halo_exchange_rows",
    "make_mesh",
    "preprocess_rows",
    "sharded_detect",
    "sharded_detect_batch",
    "std_rows",
    "windowed",
]


def _canonical(device):
    """``torch.device`` with an explicit CUDA index (``cuda`` is the
    current card), so that two slots naming one card compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A ``(dp, sp)`` grid of torch devices; ``shape`` is
    ``{"dp": dp, "sp": sp}`` as for a ``jax.sharding.Mesh``."""

    def __init__(self, devices, dp=1):
        devices = [_canonical(d) for d in devices]
        if not devices or len(devices) % dp:
            raise ValueError(f"{len(devices)} devices do not divide over "
                             f"dp={dp}")
        sp = len(devices) // dp
        self.devices = [devices[r * sp:(r + 1) * sp] for r in range(dp)]
        self.shape = {"dp": dp, "sp": sp}

    def row(self, r=0):
        """The sp devices of dp row ``r``."""
        return self.devices[r]

    @property
    def distinct(self):
        """The distinct devices of the mesh, in slot order."""
        out = []
        for dev in (d for row in self.devices for d in row):
            if dev not in out:
                out.append(dev)
        return out

    def __repr__(self):
        return (f"Mesh(dp={self.shape['dp']}, sp={self.shape['sp']}, "
                f"devices={[str(d) for d in self.distinct]})")


def make_mesh(n_devices=None, dp=1, devices=None):
    """Build a ``(dp, n // dp)`` mesh.

    ``devices`` is an explicit list and may repeat a device (``["cpu"] *
    8``); without it the mesh takes the first ``n_devices`` CUDA devices
    (all of them for None) and raises when torch sees fewer.  It never
    picks the CPU on its own.
    """
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = count if n_devices is None else int(n_devices)
        if n < 1 or n > count:
            raise RuntimeError(
                f"make_mesh: {n if n_devices is not None else 'all'} CUDA "
                f"devices requested, torch sees {count}; pass devices= "
                "explicitly (e.g. ['cpu'] * n or ['cuda:0'] * n) to put "
                "several shards on one device")
        devices = [f"cuda:{i}" for i in range(n)]
    devices = list(devices)
    if n_devices is not None:
        if int(n_devices) > len(devices):
            raise ValueError(f"make_mesh: {n_devices} devices requested, "
                             f"{len(devices)} given")
        devices = devices[:int(n_devices)]
    return Mesh(devices, dp=dp)


class RowShards:
    """A cube-sized tensor split along its row (y, next to last) axis.

    ``shards[i]`` is the ``(..., ny_loc, Nx)`` tile of rows
    ``[row_start(i), row_start(i) + ny_loc)`` on its slot's device.  It
    offers the part of a tensor's surface that the session's containers
    read (``shape``, ``dtype``, ``device``, ``cpu()``), the row windows
    that steps 08-11 cut (:meth:`rows`), and nothing that would assemble
    the cube on one device.
    """

    def __init__(self, shards):
        self.shards = list(shards)
        heights = {s.shape[-2] for s in self.shards}
        if len(heights) != 1:
            raise ValueError(f"unequal row tiles {sorted(heights)}")
        self.ny_loc = heights.pop()

    @classmethod
    def from_host(cls, array, mesh, row=0):
        """Split a host array (numpy or CPU tensor) over the sp slots of
        dp row ``row`` of ``mesh`` (or over a list of devices)."""
        devices = mesh.row(row) if isinstance(mesh, Mesh) else list(mesh)
        t = torch.as_tensor(np.ascontiguousarray(array)
                            if isinstance(array, np.ndarray) else array)
        return cls.split(t, devices)

    @classmethod
    def split(cls, tensor, devices):
        """Tiles of ``tensor`` (any device) on ``devices``, one each."""
        ny = tensor.shape[-2]
        n = len(devices)
        if ny % n:
            raise ValueError(f"Ny={ny} must divide evenly over sp={n} "
                             "row shards")
        h = ny // n
        return cls(tensor[..., i * h:(i + 1) * h, :].to(dev).contiguous()
                   for i, dev in enumerate(devices))

    # -- the tensor surface --------------------------------------------------
    @property
    def shape(self):
        s = self.shards[0].shape
        return torch.Size((*s[:-2], self.ny_loc * len(self.shards), s[-1]))

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def device(self):
        return self.shards[0].device

    @property
    def devices(self):
        return [s.device for s in self.shards]

    def numel(self):
        return sum(s.numel() for s in self.shards)

    def row_start(self, i):
        return i * self.ny_loc

    def cpu(self):
        """The whole cube as a host tensor (rows concatenated)."""
        return torch.cat([s.cpu() for s in self.shards], dim=-2)

    def to_host(self):
        """The whole cube as a host numpy array."""
        return self.cpu().numpy()

    def map(self, fn, *others):
        """``RowShards`` of ``fn(tile, other tiles...)`` per slot."""
        return RowShards(fn(*ts) for ts in zip(
            self.shards, *(o.shards for o in others)))

    # -- the reductions the shared ops take ----------------------------------
    def image(self, fn):
        """``fn`` reducing each tile over z to a ``(ny_loc, Nx)`` map: the
        maps' rows concatenated on the first tile's device."""
        return torch.cat([fn(s).to(self.device) for s in self.shards],
                         dim=-2)

    def max(self):
        """The largest value, a 0-d tensor on the first tile's device."""
        return torch.stack([s.max().to(self.device)
                            for s in self.shards]).max()

    def amax(self, dim):
        """``amax`` over z (``dim=0``, the axis no tile splits): the
        ``(Ny, Nx)`` map."""
        if dim != 0:
            raise ValueError("row shards reduce over z (dim=0) only")
        return self.image(lambda s: torch.amax(s, dim=0))

    def __mul__(self, image):
        """``cube * image`` for an ``(Ny, Nx)`` tensor: each tile times
        its rows of the image."""
        h = self.ny_loc
        return RowShards(s * image[..., i * h:(i + 1) * h, :].to(s.device)
                         for i, s in enumerate(self.shards))

    def counts_above(self, thresholds):
        """:func:`~origin_tpu_torch.ops.purity.counts_above_thresholds` of
        the cube: the tiles' integer counts summed on the thresholds'
        device, so they are the whole cube's."""
        total = None
        for s in self.shards:
            c = counts_above_thresholds(s, thresholds.to(s.device))
            c = c.to(thresholds.device)
            total = c if total is None else total + c
        return total

    def encode_i16(self, scale=None):
        """:func:`~origin_tpu_torch.ops.quant.encode_i16` of the cube: one
        scale from the largest of the tiles' maxima, and the tiles' int16
        values concatenated on the host, the bits of the whole cube's
        encoding."""
        if scale is None:
            amax = torch.stack([abs_max(s).cpu() for s in self.shards]).max()
            scale = float(i16_scale(amax))
        return torch.cat([encode_i16(s, scale)[0].cpu()
                          for s in self.shards], dim=-2), scale

    def sparse_i16(self, scale=None):
        """:func:`~origin_tpu_torch.ops.quant.sparse_i16` of the cube: the
        tiles' nonzero entries gathered on the first tile's device, put in
        the whole cube's flat order and quantized as the cube's are."""
        ny, nx = self.shape[-2:]
        idx, vals = [], []
        for i, s in enumerate(self.shards):
            z, y, x = torch.nonzero(s, as_tuple=True)
            idx.append(((z * ny + y + self.row_start(i)) * nx + x)
                       .to(self.device))
            vals.append(s[z, y, x].to(torch.float32).to(self.device))
        order = torch.argsort(torch.cat(idx), stable=True)
        return quantize_pairs(torch.cat(idx)[order], torch.cat(vals)[order],
                              self.numel(), scale)

    def rows(self, y0, y1, device=None):
        """Rows ``[y0, y1)`` (inside the cube) as one tensor on ``device``
        (the device of the tile holding ``y0``), read from the tiles that
        hold them."""
        y0, y1 = max(0, int(y0)), min(self.shape[-2], int(y1))
        h = self.ny_loc
        first = min(y0 // h, len(self.shards) - 1)
        if device is None:
            device = self.shards[first].device
        parts = []
        for i in range(first, len(self.shards)):
            lo, hi = max(y0, i * h), min(y1, (i + 1) * h)
            if lo >= hi:
                break
            parts.append(self.shards[i][..., lo - i * h:hi - i * h, :]
                         .to(device))
        if len(parts) == 1:
            return parts[0]
        return torch.cat(parts, dim=-2)

    def __repr__(self):
        return (f"<RowShards {tuple(self.shape)} {self.dtype} in "
                f"{len(self.shards)} tiles of {self.ny_loc} rows on "
                f"{sorted({str(d) for d in self.devices})}>")


def _tiles(x):
    return x.shards if isinstance(x, RowShards) else list(x)


def halo_exchange_rows(shards, halo):
    """Each tile with ``halo`` rows of its neighbours above and below.

    ``shards`` is a :class:`RowShards` or a list of ``(..., ny_loc, Nx)``
    tiles; the outer edges of the first and last tile get zeros (the
    global zero padding of the convolution).  A neighbour's rows are
    copied to the tile's device.  With ``halo == 0`` the tiles come back
    unchanged; one tile is zero-padded.
    """
    tiles = _tiles(shards)
    if halo == 0:
        return tiles
    if halo > tiles[0].shape[-2]:
        raise ValueError(f"halo {halo} is taller than a tile "
                         f"({tiles[0].shape[-2]} rows)")
    out = []
    n = len(tiles)
    for i, t in enumerate(tiles):
        zeros = t.new_zeros((*t.shape[:-2], halo, t.shape[-1]))
        top = tiles[i - 1][..., -halo:, :].to(t.device) if i > 0 else zeros
        bottom = (tiles[i + 1][..., :halo, :].to(t.device) if i < n - 1
                  else zeros)
        out.append(torch.cat([top, t, bottom], dim=-2))
    return out


def _row_groups(cube, y0, size):
    """Windows of ``size`` rows starting at rows ``y0`` (numpy ints, may
    lie outside the cube), grouped by the tile that holds their first
    in-field row.

    Yields ``(sel, s0, s1, device)``: the windows' indices and the band
    of rows ``[s0, s1) = [s0, min(Ny, tile end + size - 1))`` that holds
    every in-field row of the group's windows, with the tile's device.
    Inside the band, a window row falls outside the band exactly where it
    falls outside the cube, so a window function given the band and
    ``y0 - s0`` fills what it fills on the whole cube.
    """
    ny, h = cube.shape[-2], cube.ny_loc
    grp = np.clip(np.asarray(y0), 0, ny - 1) // h
    # no windows: the first band, for the empty results' shapes
    for i in np.unique(grp) if grp.size else [0]:
        s0 = int(i) * h
        yield (np.flatnonzero(grp == i), s0, min(ny, s0 + h + size - 1),
               cube.shards[i].device)


def windowed(fn, cube, y0, size, *args, device=None):
    """``fn(cube, y0, *args)`` for a batch of windows, on a tensor or on
    :class:`RowShards`.

    ``fn`` cuts windows of ``size`` rows starting at rows ``y0`` (one per
    window, possibly outside the cube).  ``cube`` is one cube or a tuple
    of cubes of one layout (the inputs: cube, variance, mask), which
    ``fn`` then takes as its first argument.  ``fn`` returns a tensor, or
    a tuple of tensors, with the window axis first, or a dict keyed by
    window; ``args`` are per-window arrays (numpy or tensors).  On row
    shards it runs once per band of rows that holds a group of windows
    (:func:`_row_groups`), with ``y0`` and the args of the group's
    windows; tensors come back in window order on ``device`` (the first
    tile's by default), dicts merged.
    """
    lead = cube[0] if isinstance(cube, tuple) else cube
    if not isinstance(lead, RowShards):
        return fn(cube, y0, *args)
    device = lead.device if device is None else device
    y0_host = y0.cpu().numpy() if torch.is_tensor(y0) else np.asarray(y0)

    def pick(a, sel, dev):
        if torch.is_tensor(a):
            return a[torch.as_tensor(sel, device=a.device)].to(dev)
        return np.asarray(a)[sel]

    parts, order = [], []
    for sel, s0, s1, dev in _row_groups(lead, y0_host, size):
        band = (tuple(c.rows(s0, s1, dev) for c in cube)
                if isinstance(cube, tuple) else lead.rows(s0, s1, dev))
        parts.append(fn(band, pick(y0, sel, dev) - s0,
                        *(pick(a, sel, dev) for a in args)))
        order.append(sel)
    if isinstance(parts[0], dict):
        return {k: v for p in parts for k, v in p.items()}
    single = not isinstance(parts[0], tuple)
    if single:
        parts = [(p,) for p in parts]
    inv = torch.as_tensor(np.argsort(np.concatenate(order), kind="stable"),
                          device=device)
    out = tuple(torch.cat([p[k].to(device) for p in parts])[inv]
                for k in range(len(parts[0])))
    return out[0] if single else out


def std_rows(x):
    """Population standard deviation of a tensor or of row shards, the
    latter from float64 sums over the tiles."""
    if not isinstance(x, RowShards):
        return float(torch.std(x, correction=0))
    n = x.numel()
    mean = sum(float(s.double().sum()) for s in x.shards) / n
    ss = sum(float(((s.double() - mean) ** 2).sum()) for s in x.shards)
    return float(np.float32(np.sqrt(ss / n)))


# -- step 01 on row shards ----------------------------------------------------
def _local_max_sharded(x, mask, size):
    """Local maxima of row-sharded ``x`` (halo ``size//2`` rows).

    Halo rows outside the cube (the zero fill of the outer tiles) are
    forced to ``-inf``, so the filter matches the single device's ``-inf``
    padding also for negative data.  Returns :class:`RowShards`.
    """
    tiles, masks = _tiles(x), _tiles(mask)
    halo = size // 2
    xp = halo_exchange_rows(tiles, halo)
    n = len(tiles)
    out = []
    for i, (t, m, p) in enumerate(zip(tiles, masks, xp)):
        ny = t.shape[-2]
        if halo:
            row = torch.arange(p.shape[-2], device=p.device)
            outside = (((i == 0) & (row < halo))
                       | ((i == n - 1) & (row >= ny + halo)))
            p = torch.where(outside[:, None], float("-inf"), p)
        filt = _maxfilter(p, (size,) * 3)[:, halo:halo + ny, :]
        keep = (t == filt) & ~m
        out.append(torch.where(keep, filt, 0.0))
    return RowShards(out)


def preprocess_rows(cube, var, mask, dct_order=10, dct_approx=False,
                    local_max_size=3, voxel_weights=False):
    """Step 01 on row shards: per tile the DCT continuum and its
    coefficients, the channel means as the sum of the tiles' partial sums
    (in slot order), the standardization, and the local extrema with
    ``size//2`` halo rows.

    The DCT fit weighs by the inverse variance and gives a spaxel with a
    masked voxel unit weights, as the session does (``ops.dct``); with
    ``voxel_weights`` only the masked voxels take unit weight, as the JAX
    package's ``detect_tile_kernel`` weighs them.

    Returns ``(cube_std, cont_std, coef, mean_z, lmax, lmin)``: row
    shards but ``mean_z``, an (Nz,) tensor on the first tile's device.
    """
    cubes, vars_, masks = _tiles(cube), _tiles(var), _tiles(mask)
    dev0 = cubes[0].device
    conts, coefs, sums, counts = [], [], [], []
    for c, v, m in zip(cubes, vars_, masks):
        if voxel_weights:
            cont, coef = dct_residual(c, dct_order,
                                      var=torch.where(m, 1.0, v),
                                      approx=dct_approx, with_coef=True)
        else:
            cont, coef = dct_residual(c, dct_order, var=v,
                                      approx=dct_approx, mask=m,
                                      with_coef=True)
        good = ~m
        sums.append(torch.where(good, c - cont, 0.0).sum(dim=(1, 2))
                    .to(dev0))
        counts.append(good.sum(dim=(1, 2)).to(dev0))
        conts.append(cont)
        coefs.append(coef)
    total = sums[0]
    for s in sums[1:]:
        total = total + s
    ngood = counts[0]
    for k in counts[1:]:
        ngood = ngood + k
    mean_z = total / torch.clamp(ngood, min=1)
    data, cont_std = [], []
    for i, (c, v, m) in enumerate(zip(cubes, vars_, masks)):
        d, k = standardize(c, conts[i], v, m,
                           mean_z=mean_z.to(c.device))
        conts[i] = None
        data.append(d)
        cont_std.append(k)
    data = RowShards(data)
    lmax = _local_max_sharded(data, masks, local_max_size)
    lmin = _local_max_sharded(data.map(torch.neg), masks, local_max_size)
    return (data, RowShards(cont_std), RowShards(coefs), mean_z, lmax,
            lmin)


# -- step 05 on row shards ----------------------------------------------------
def build_tile_spatial_op(psf, ny_loc, nx, halo=None, device="cpu"):
    """Per-tile spatial FSF operator for a halo-extended row tile.

    The FSF spectra (of the flipped zero-mean kernel and of its square) on
    the tile's own DFT grid, taken by ``torch.fft`` in float64 on
    ``device`` (the mesh's first slot: a field's 3681 channels take
    seconds on the host), and the DFT-matmul factor matrices, whose
    inverse side folds in the 'same' offset and the halo trim
    (:func:`~origin_tpu_torch.ops.glr.dft_spatial_factors`).  The halo
    pads the row (y) axis, so it is sized from the FSF's y extent.
    Returns ``(spatial_op, halo)``: the spectra as float32 tensors on
    ``device`` and the factors as float32 host arrays.
    """
    psf = np.asarray(psf, dtype=np.float32)
    ph, pw = psf.shape[-2:]
    if halo is None:
        halo = (ph - 1) // 2
    if ny_loc < halo:
        # the halo exchange is single-hop (immediate neighbours), so each
        # tile must be at least one halo tall
        raise ValueError(
            f"tile height {ny_loc} is smaller than the FSF halo ({halo}); "
            "use fewer sp shards or a taller field"
        )
    nyp = ny_loc + 2 * halo
    fshape = (nyp + ph - 1, nx + pw - 1)
    factors = dft_spatial_factors(
        nyp, nx, fshape, (ph, pw), ny_out=ny_loc, y_extra=halo
    )
    kern = torch.flip(torch.as_tensor(psf, device=device), dims=(1, 2))
    kern = kern - torch.mean(kern, dim=(1, 2), keepdim=True)
    hats = (torch.fft.rfft2(kern.double(), s=fshape),
            torch.fft.rfft2((kern * kern).double(), s=fshape))
    spatial_op = dict(
        kern_r=hats[0].real.float().contiguous(),
        kern_i=hats[0].imag.float().contiguous(),
        kern2_r=hats[1].real.float().contiguous(),
        kern2_i=hats[1].imag.float().contiguous(),
        factors=factors,
    )
    return spatial_op, halo


def _op_on(op, device, cache):
    """The tensors of a spatial op on ``device`` (uploaded once)."""
    key = (id(op), device)
    if key not in cache:
        t = lambda a: torch.as_tensor(a, device=device)  # noqa: E731
        cache[key] = dict(
            {k: t(op[k]) for k in ("kern_r", "kern_i", "kern2_r",
                                   "kern2_i")},
            factors={k: t(v) for k, v in op["factors"].items()})
    return cache[key]


def _conv2d_same_local_matmul(tiles, ops, kern, halo):
    """'same' per-channel convolution of row tiles by DFT matmuls:
    :func:`~origin_tpu_torch.ops.glr.glr_spatial_matmul` on each
    halo-extended tile with the ``kern`` (``"kern"`` or ``"kern2"``)
    spectra of ``ops[i]``, the tile's op on its device; the factors trim
    the halo."""
    padded = halo_exchange_rows(tiles, halo)
    return [glr_spatial_matmul(p, o[kern + "_r"][None], o[kern + "_i"][None],
                               None, o["factors"])
            for p, o in zip(padded, ops)]


def glr_tile(faint, mask, spatial_op, t_num, t_den, pad_left, nz,
             local_max_size=3, halo=0, wtiles=None, precision="highest",
             prof_dtype=None):
    """Step 05 on row shards: the tiles' spatial FSF stage with halo
    exchange, the spectral sweep of each tile (the CUDA kernel on a CUDA
    tile: one launch per tile) at ``precision``, masking, the local
    extrema and the max/min maps.

    ``spatial_op`` is one :func:`build_tile_spatial_op` dict or, for a
    mosaic, a list of them with ``wtiles``, the ``(F, Ny, Nx)`` field
    weights as row shards: each field's FSF convolves the weighted tile
    and the results sum, as on a single device.  ``t_num``/``t_den`` are
    the host banks of :func:`~origin_tpu_torch.ops.glr.
    pack_profiles_toeplitz`.  Returns ``(correl, correl_min, profile,
    lmax, lmin, maxmap, minmap)``, all :class:`RowShards` (the maps of
    ``(ny_loc, Nx)`` tiles); ``profile`` in ``prof_dtype`` when given.
    """
    ops = [spatial_op] if isinstance(spatial_op, dict) else list(spatial_op)
    fts, mts = _tiles(faint), _tiles(mask)
    wts = None if wtiles is None else _tiles(wtiles)
    cache = {}
    banks = {}
    # the spatial stage of every tile first: the halo exchange reads the
    # neighbours' faint rows
    fsf = [None] * len(fts)
    norm = [None] * len(fts)
    for f, op in enumerate(ops):
        if wts is None:
            data = fts
            base = [torch.ones((1, *t.shape[1:]), dtype=t.dtype,
                               device=t.device) for t in fts]
        else:
            data = [t * w[f][None] for t, w in zip(fts, wts)]
            base = [w[f][None] for w in wts]
        dev_ops = [_op_on(op, t.device, cache) for t in fts]
        cf = _conv2d_same_local_matmul(data, dev_ops, "kern", halo)
        nf = _conv2d_same_local_matmul(base, dev_ops, "kern2", halo)
        del data, base
        for i, (c, b) in enumerate(zip(cf, nf)):
            fsf[i] = c if fsf[i] is None else fsf[i] + c
            norm[i] = b if norm[i] is None else norm[i] + b
        del cf, nf
    correl, cmin, prof, maxmap, minmap = [], [], [], [], []
    for i, m in enumerate(mts):
        dev = m.device
        if dev not in banks:
            banks[dev] = (torch.as_tensor(t_num, device=dev),
                          torch.as_tensor(t_den, device=dev))
        c, p, cm = spectral_sweep(fsf[i].contiguous(), norm[i].contiguous(),
                                  *banks[dev], pad_left, nz,
                                  precision=precision)
        fsf[i] = norm[i] = None
        c.masked_fill_(m, 0.0)
        cm.masked_fill_(m, 0.0)
        p.masked_fill_(m, 0)
        if prof_dtype is not None:
            p = p.to(prof_dtype)
        correl.append(c)
        cmin.append(cm)
        prof.append(p)
        maxmap.append(torch.amax(c, dim=0))
        minmap.append(torch.amin(cm, dim=0))
    correl, cmin = RowShards(correl), RowShards(cmin)
    lmax = _local_max_sharded(correl, mts, local_max_size)
    lmin = _local_max_sharded(cmin.map(torch.neg), mts, local_max_size)
    return (correl, cmin, RowShards(prof), lmax, lmin, RowShards(maxmap),
            RowShards(minmap))


def detect_tile_kernel(cube, var, mask, spatial_op, t_num, t_den,
                       thresholds, pad_left=0, local_max_size=3, halo=0,
                       dct_order=10, precision="highest"):
    """The detection of one cube on row shards: step 01's DCT and
    standardization (:func:`preprocess_rows`), the GLR tiles
    (:func:`glr_tile`) and the purity counts, summed integer counts of the
    tiles.  Returns ``(local_max, local_min, counts_max, counts_min)``:
    two :class:`RowShards` and two (T,) int64 tensors."""
    nz = cube.shape[0]
    data = preprocess_rows(cube, var, mask, dct_order,
                           voxel_weights=True)[0]
    _, _, _, lmax, lmin, _, _ = glr_tile(
        data, mask, spatial_op, t_num, t_den, pad_left, nz,
        local_max_size=local_max_size, halo=halo, precision=precision)
    th = torch.as_tensor(thresholds, dtype=torch.float32, device=data.device)
    return lmax, lmin, lmax.counts_above(th), lmin.counts_above(th)


class ShardedPipeline:
    """The detection step of a batch of cubes over a ``(dp, sp)`` mesh.

    Cube ``b`` of a batch of ``B`` (a multiple of dp) runs on dp row
    ``b // (B // dp)``, its rows split over that row's sp slots.  The
    kernel is chosen by each tile's device (:func:`glr_tile`), at
    ``precision`` (``"highest"`` or ``"bf16x3"``).
    """

    def __init__(self, mesh, nz, ny, nx, psf, profiles, dct_order=10,
                 local_max_size=3, thresholds=None, precision="highest"):
        self.mesh = mesh
        self.sp = mesh.shape["sp"]
        self.dp = mesh.shape["dp"]
        if ny % self.sp != 0:
            raise ValueError(f"ny={ny} must divide over sp={self.sp} shards")
        self.shape = (nz, ny, nx)
        self.precision = precision
        self.psf = np.asarray(psf, dtype=np.float32)
        prepped = prepare_profiles(profiles)
        self.t_num, self.t_den, self.pad_left, _ = pack_profiles_toeplitz(
            prepped, block=min(128, nz))
        # the per-tile spatial FSF operator on the halo-extended tile's
        # own DFT grid, its spectra taken on the mesh's first slot
        self.spatial_op, self.halo = build_tile_spatial_op(
            self.psf, ny // self.sp, nx, device=mesh.row(0)[0])
        self.dct_order = dct_order
        if thresholds is None:
            thresholds = np.linspace(2.0, 12.0, 50)
        self.thresholds = np.asarray(thresholds, dtype=np.float32)
        self.local_max_size = local_max_size

    def __call__(self, cubes, variances, masks):
        """Run the detection on a ``(B, Nz, Ny, Nx)`` host batch.

        Returns ``(local_max, local_min, counts_max, counts_min)``: two
        lists of B :class:`RowShards` and two (B, T) int64 numpy arrays,
        the counts over each whole cube.
        """
        b = len(cubes)
        if b % self.dp != 0:
            raise ValueError(f"batch {b} must divide over dp={self.dp}")
        per_row = b // self.dp
        lmax, lmin, cmax, cmin = [], [], [], []
        for j in range(b):
            row = j // per_row
            put = lambda a: RowShards.from_host(  # noqa: E731
                np.asarray(a), self.mesh, row)
            out = detect_tile_kernel(
                put(np.asarray(cubes[j], np.float32)),
                put(np.asarray(variances[j], np.float32)),
                put(np.asarray(masks[j], bool)), self.spatial_op,
                self.t_num, self.t_den, self.thresholds,
                pad_left=self.pad_left, local_max_size=self.local_max_size,
                halo=self.halo, dct_order=self.dct_order,
                precision=self.precision)
            lmax.append(out[0])
            lmin.append(out[1])
            cmax.append(out[2].cpu().numpy())
            cmin.append(out[3].cpu().numpy())
        return lmax, lmin, np.stack(cmax), np.stack(cmin)


def sharded_detect(mesh, cube, var, mask, psf, profiles, **kwargs):
    """One-shot helper: the sharded detection of a single cube.  Returns
    host arrays ``(local_max, local_min, counts_max, counts_min)``."""
    nz, ny, nx = cube.shape
    pipe = ShardedPipeline(mesh, nz, ny, nx, psf, profiles, **kwargs)
    lmax, lmin, cmax, cmin = pipe(cube[None], var[None], mask[None])
    return lmax[0].to_host(), lmin[0].to_host(), cmax[0], cmin[0]


def sharded_detect_batch(mesh, cubes, variances, masks, psf, profiles,
                         **kwargs):
    """The sharded detection of a batch of cubes (dp x sp)."""
    nz, ny, nx = cubes.shape[1:]
    pipe = ShardedPipeline(mesh, nz, ny, nx, psf, profiles, **kwargs)
    return pipe(cubes, variances, masks)
