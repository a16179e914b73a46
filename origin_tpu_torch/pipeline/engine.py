"""Device-resident execution engine for the detection front end.

Torch port of the main-path subset of
:class:`origin_tpu.pipeline.engine.DeviceEngine`: steps 01 (DCT +
standardization + local extrema), 04 (greedy PCA per area), 05 (GLR
matched filter) and 07 (detection extraction) keep every cube-sized
intermediate on the session's device, and only 2-D images, per-area
vectors, (50,)-vectors and sparse detection lists come back to the host.

The JAX engine's transfer machinery (streamed ingest, int16 and
bit-packed wires, speculative and bucketed compaction, host rebuilds)
exists for a slow TPU host link and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device, set_precision
from ..ops.convolve import fft2_shape
from ..ops.dct import dct_residual
from ..ops.glr import (
    dft_spatial_factors,
    glr_spatial_matmul,
    pack_profiles_toeplitz,
    precompute_spatial,
    prepare_profiles,
)
from ..ops.localmax import compute_local_max
from ..ops.pca import greedy_pca
from ..ops.stats import o2test, standardize
from ..ops.sweep import spectral_sweep
from .products import TensorCube

__all__ = ["TorchEngine"]


def _derive_inputs(raw, var_raw):
    """Zero-filled cube, inf-filled variance and NaN mask from the raw
    uploads (the host filled()/var_filled() views, computed on device)."""
    mask = ~torch.isfinite(raw)
    cube = torch.where(mask, 0.0, raw)
    var = torch.where(mask | ~torch.isfinite(var_raw), float("inf"), var_raw)
    return cube, var, mask


def _mask_extrema(correl, correl_min, profile, mask, size, prof_dtype=None):
    """Masking + 3-D local extrema + max/min maps."""
    correl = torch.where(mask, 0.0, correl)
    correl_min = torch.where(mask, 0.0, correl_min)
    profile = torch.where(mask, torch.zeros((), dtype=profile.dtype,
                                            device=profile.device), profile)
    lmax, lmin = compute_local_max(correl, correl_min, mask, size)
    minmap = torch.amin(correl_min, dim=0)
    if prof_dtype is not None:
        profile = profile.to(prof_dtype)
    return (correl, correl_min, profile, lmax, lmin,
            torch.amax(correl, dim=0), minmap)


def _host(t):
    return t.cpu().numpy()


class TorchEngine:
    """Per-session holder of device-resident front-end state.

    ``device`` is explicit (``"cuda"`` or ``"cpu"``); constructing the
    engine sets the float32 precision contract (:func:`set_precision`).
    """

    def __init__(self, orig, device):
        self.orig = orig
        self.device = resolve_device(device)
        set_precision()
        self._inputs = {}

    # -- inputs ------------------------------------------------------------
    def _upload(self, arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def _upload_inputs(self):
        """(cube, var, mask) on device.

        A cube without a mask extension uploads its raw data and variance
        and derives the zero-filled / inf-filled / mask triple on device;
        otherwise the three host views are uploaded.
        """
        c = self.orig.cube
        if c.mask is not None:
            return (self._upload(self.orig.cube_raw),
                    self._upload(self.orig.var),
                    self._upload(self.orig.mask))
        raw = self._upload(np.asarray(c.data, np.float32))
        if c.var is not None:
            var_raw = self._upload(np.asarray(c.var, np.float32))
        else:
            var_raw = torch.ones(c.data.shape, dtype=torch.float32,
                                 device=self.device)
        return _derive_inputs(raw, var_raw)

    def _ensure_inputs(self):
        if not self._inputs:
            cube, var, mask = self._upload_inputs()
            self._inputs.update(cube=cube, var=var, mask=mask)

    def input_cube(self):
        self._ensure_inputs()
        return self._inputs["cube"]

    def input_var(self):
        self._ensure_inputs()
        return self._inputs["var"]

    def input_mask(self):
        self._ensure_inputs()
        return self._inputs["mask"]

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
        for name, val in state_from_numpy(arrays, self.device).items():
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

    def get(self, name):
        """Device tensor of a cube-sized session product."""
        owner = self.orig._product_owner.get(name)
        obj = owner.store.peek(name) if owner is not None else None
        if not isinstance(obj, TensorCube):
            raise KeyError(f"no cube product {name!r} in this session")
        return obj.tensor

    # -- step 01 -----------------------------------------------------------
    def preprocess(self, dct_order=10, dct_approx=False, local_max_size=3):
        """DCT + standardization + std local extrema.

        Returns (device dict, host dict): the cube-sized products stay on
        device; the 2-D images come back as numpy.
        """
        cube, var, mask = (self.input_cube(), self.input_var(),
                           self.input_mask())
        cont = dct_residual(cube, dct_order, var=var, approx=dct_approx,
                            mask=mask)
        data, cont_std = standardize(cube, cont, var, mask)
        del cont
        lmax, lmin = compute_local_max(data, data, mask, local_max_size)
        host = dict(
            ima_std=_host(torch.mean(data, dim=0)),
            ima_dct=_host(torch.mean(cont_std, dim=0)),
            o2=_host(o2test(data)),
            cont_sumsq=_host(torch.sum(cont_std * cont_std, dim=0)),
        )
        dev = dict(cube_std=data, cont_dct=cont_std,
                   cube_std_local_max=lmax, cube_std_local_min=lmin)
        return dev, host

    # -- step 04 -----------------------------------------------------------
    def greedy_pca_by_area(self, areamap, thresholds, testO2,
                           noise_population=50.0, itermax=100):
        """Zone-wise greedy PCA with device-resident gather/scatter.

        Per area, the (Nz, Npix_area) column block is gathered on device,
        cleaned by :func:`greedy_pca` and scattered back into a copy of
        ``cube_std``.  Returns ``(faint, mapO2, nstop)``.
        """
        cube_std = self.get("cube_std")
        nz = cube_std.shape[0]
        spatial_shape = tuple(cube_std.shape[1:])
        flat = cube_std.reshape(nz, -1).clone()
        areamap = np.asarray(areamap)
        mapO2 = np.zeros(spatial_shape, dtype=np.int32)
        nstop = 0
        for area in range(1, int(areamap.max()) + 1):
            (idx,) = np.nonzero((areamap == area).ravel())
            if idx.size == 0:
                continue
            didx = self._upload(idx.astype(np.int64))
            cols = flat[:, didx]
            valid = torch.ones(idx.size, dtype=torch.bool, device=self.device)
            test = self._upload(np.asarray(testO2[area - 1], np.float32))
            faint, m, k = greedy_pca(
                cols, valid, test, float(thresholds[area - 1]),
                noise_population=float(noise_population),
                itermax=int(itermax),
            )
            flat[:, didx] = faint
            mapO2.ravel()[idx] = _host(m)
            nstop += int(k)
        return flat.reshape(cube_std.shape), mapO2, nstop

    # -- step 05 -----------------------------------------------------------
    def tglr(self, psf, wfields, profiles, pcut=1e-8, pmeansub=True, size=3):
        """GLR matched filter + local extrema, all device-resident.

        Instrument-model precompute (FSF spectra + norm cube), spatial FSF
        stage, the spectral sweep (:func:`spectral_sweep`: the CUDA kernel
        on a GPU), masking, local extrema and the max/min maps.  Returns
        (device dict, host dict with the maxmap/minmap images).
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
        nprof = len(prepped)
        if nprof <= np.iinfo(np.uint8).max:
            prof_dtype = torch.uint8  # the reference's in-memory dtype
        elif nprof <= np.iinfo(np.int16).max:
            prof_dtype = torch.int16
        else:
            prof_dtype = None  # keep the kernel's int32 indices
        factors = {
            k: self._upload(v)
            for k, v in dft_spatial_factors(
                ny, nx, fshape2, psfs.shape[-2:]).items()
        }

        kern_hats, norm_fsf = precompute_spatial(self._upload(psfs), wmaps,
                                                 ny, nx, fshape2)
        kern_r = kern_hats.real.contiguous()
        kern_i = kern_hats.imag.contiguous()
        del kern_hats
        cube_fsf = glr_spatial_matmul(faint, kern_r, kern_i, wmaps, factors)
        del kern_r, kern_i
        correl, profile, correl_min = spectral_sweep(
            cube_fsf.contiguous(), norm_fsf, self._upload(t_num),
            self._upload(t_den), pad_left, nz)
        del cube_fsf, norm_fsf
        (correl, correl_min, profile, lmax, lmin, maxmap,
         minmap) = _mask_extrema(correl, correl_min, profile,
                                 self.input_mask(), size,
                                 prof_dtype=prof_dtype)
        dev = dict(cube_correl=correl, cube_correl_min=correl_min,
                   cube_profile=profile, cube_local_max=lmax,
                   cube_local_min=lmin)
        return dev, dict(maxmap=_host(maxmap), minmap=_host(minmap))

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
