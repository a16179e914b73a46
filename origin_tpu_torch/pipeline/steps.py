"""Steps 01-11 of the pipeline and the stage protocol that drives them.

Port of :mod:`origin_tpu.pipeline.steps`: the same parameters, products
and host logic, with the cube-sized math on the session's torch device
(:class:`.engine.TorchEngine`).  Each cube product is stored in the JAX
package's default form (``forms``, and the recipes of steps 01 and 04).  A
resumed session's parked cube products come back on the session's device
at their first fetch (:meth:`Step._load_recipe_product`,
:meth:`Step._upload_cube`), so its steps take the same device paths as an
uninterrupted run.  On a tight-memory session steps 01, 04 and 05 move
their finished products off the device (``TorchEngine.maybe_offload``),
as the JAX package's do.  The JAX package's TPU-link machinery (device
drops, prefetches, background parking, the lazy re-upload of a resumed
session's detection cubes) is not ported.
"""

from __future__ import annotations

import inspect
import logging
import os
import shutil
from collections import OrderedDict
from datetime import datetime
from enum import Enum, auto

import numpy as np
import torch
from scipy import ndimage as ndi

from .. import tracing
from ..artifacts.masks import _fetch_line_images, create_masks
from ..artifacts.source import _moffat_weight_cube
from ..artifacts.source_creation import create_all_sources
from ..core.containers import Image, Spectrum, cutout_window
from ..core.fsf import combine_fsf, field_weights, read_fsf_from_header
from ..core.table import Table, vstack
from ..detect import (
    add_tglr_stat,
    area_growing,
    area_segmentation_convex_fusion,
    area_segmentation_final,
    area_segmentation_sources_fusion,
    area_segmentation_square_fusion,
    compute_segmap_gauss,
    deblend_sources,
    filter_duplicate_lines,
    merge_similar_lines,
    purity_estimation,
    spatiospectral_merging,
    unique_sources,
)
from ..ops.cutouts import window_ori_stats
from ..ops.lines import estimation_line_arrays
from ..ops.purity import compute_threshold_purity_pair
from ..ops.stats import compute_thresh_gaussfit, o2test
from ..parallel.mesh import windowed
from .products import ProductStore, TensorCube, format_catalog
from .recipes import is_recipe_file, load_recipe, recipe_writer

__all__ = [
    "Preprocessing",
    "CreateAreas",
    "ComputePCAThreshold",
    "ComputeGreedyPCA",
    "ComputeTGLR",
    "ComputePurityThreshold",
    "Detection",
    "ComputeSpectra",
    "CleanResults",
    "CreateMasks",
    "SaveSources",
    "Status",
    "Step",
    "STEPS",
]


class Status(Enum):
    """Lifecycle of a step within a session.

    NOTRUN -> RUN (computed, products live in memory) -> DUMPED (products
    parked in the session directory); FAILED if ``run`` raised.  Only the
    member *names* are persisted in the session parameter file.
    """

    NOTRUN = auto()
    RUN = auto()
    DUMPED = auto()
    FAILED = auto()


class Step:
    """One pipeline stage bound to an ORIGIN session.

    Subclasses declare ``name`` / ``desc``, ``products`` (product name ->
    kind), ``forms`` (cube product name -> its compact form, see
    :func:`.products.stored_form`) and ``depends_on``, and implement
    ``run(orig, **params)``.
    Calling the step records its effective parameters, checks its
    dependencies, times the run and tracks a :class:`Status`.  Products are
    published with :meth:`put` and read back as attributes, whether live
    or parked on disk.
    """

    name = ""
    desc = ""
    products = {}
    forms = {}
    depends_on = ()

    def __init__(self, orig, idx, param):
        self.logger = logging.getLogger(__name__)
        self.orig = orig
        self.idx = idx
        self.method_name = f"step{idx:02d}_{self.name}"
        self.store = ProductStore(self.products)
        self.store.resolve = self._load_recipe_product
        self.store.upload = self._upload_cube
        meta = param.setdefault(self.name, {})
        meta.setdefault("stepidx", idx)
        self.meta = meta
        self.param = meta.setdefault("params", {})

    def __repr__(self):
        return (
            f"<{type(self).__name__} [{self.idx:02d}] {self.status.name}>"
        )

    def _load_recipe_product(self, path):
        """Session-aware reader of a recipe-form cube product (None for
        any other file): lazy, so that only a full fetch rebuilds the
        dense cube, against this session's raw data."""
        if not is_recipe_file(path):
            return None
        cube = load_recipe(path, orig=self.orig, lazy=True)
        cube._recipe_source = path  # park skips rewriting this file
        return cube

    def _upload_cube(self, cube):
        """A cube product read back from its session file, on the
        session's device (its first fetch).  It keeps its file's form: the
        recipe, or the scale of a compact file (see ``TensorCube``)."""
        tensor = self.orig.engine.resident(
            torch.from_numpy(np.ascontiguousarray(cube.data)))
        wire = getattr(cube, "_wire16", None)
        form = scale = None
        if wire is not None:
            form = "int16" if wire.pairs is None else "sparse"
            scale = wire.scale
        return TensorCube(tensor,
                          wcs=self.orig.wcs, wave=self.orig.wave, form=form,
                          scale=scale, recipe=getattr(cube, "recipe", None),
                          recipe_source=getattr(cube, "_recipe_source", None))

    def __getattr__(self, name):
        # products read as attributes, materializing parked files on demand
        store = self.__dict__.get("store")
        if store is not None and name in store:
            return store.fetch(name)
        raise AttributeError(
            f"{type(self).__name__} has no attribute {name!r}"
        )

    @property
    def status(self):
        val = self.meta.get("status", Status.NOTRUN)
        return Status[val] if isinstance(val, str) else val

    @status.setter
    def status(self, val):
        self.meta["status"] = val

    def _record_params(self, args, kwargs):
        """Capture the call's effective parameters (positional ones too)."""
        sig = inspect.signature(self.run)
        try:
            bound = sig.bind(None, *args, **kwargs)  # None stands for orig
        except TypeError:
            bound = None  # run() itself will raise the clearer error
        for pname, p in sig.parameters.items():
            if pname == "orig":
                continue
            if bound is not None and pname in bound.arguments:
                value = bound.arguments[pname]
            else:
                value = p.default
            self.param[pname] = value
            if value is not p.empty:
                self.logger.debug("   %s = %r", pname, value)

    def _check_dependencies(self):
        for req in self.depends_on:
            dep = self.orig.steps[req]
            if dep.status not in (Status.RUN, Status.DUMPED):
                raise RuntimeError(
                    f"{self.method_name} requires {dep.method_name} "
                    f"(status: {dep.status.name})"
                )

    def __call__(self, *args, **kwargs):
        self.logger.info("Step %02d - %s", self.idx, self.desc)
        engine = getattr(self.orig, "engine", None)
        with tracing.step_span(
                f"step{self.idx:02d}", getattr(engine, "device", None),
                field=getattr(self.orig, "trace_field", None)) as span:
            self._span = span
            self._record_params(args, kwargs)
            self._check_dependencies()
            try:
                self.run(self.orig, *args, **kwargs)
            except Exception:
                self.status = Status.FAILED
                raise
        self.status = Status.RUN
        self.meta["runtime"] = elapsed = span.elapsed_s
        self.meta["execution_date"] = datetime.now().isoformat()
        self.logger.info("Step %02d finished (%.2f s)", self.idx, elapsed)

    def put(self, name, value):
        """Publish a product (must be declared in ``products``)."""
        self.store.stash(name, value)

    def store_cube_dev(self, name, tensor, recipe=None):
        """Publish a device-resident cube product, in its declared form;
        ``recipe`` is the writer of its recipe file."""
        self.put(name, TensorCube(self.orig.engine.resident(tensor),
                                  wcs=self.orig.wcs, wave=self.orig.wave,
                                  form=self.forms.get(name), recipe=recipe))

    def recipe(self, kind, payload):
        """The writer of a recipe file of ``kind`` (``recipes.py``), or
        None for a session made from an in-memory cube: a recipe is
        rebuilt from the cube file it names."""
        cubename = self.orig.param.get("cubename")
        return recipe_writer(kind, payload, cubename) if cubename else None

    def store_image(self, name, data, **kwargs):
        self.put(name, Image(data=data, wcs=self.orig.wcs, mask=False,
                             copy=False, **kwargs))

    def dump(self, outpath):
        """Park every live product in the session directory."""
        if self.status is Status.RUN:
            self.logger.debug("parking %s products", self.method_name)
            self.store.park_all(outpath)
            self.status = Status.DUMPED
        elif self.status is Status.DUMPED:
            # already-dumped step on a resumed session: persist exactly
            # the products whose content was replaced since their fetch
            self.store.park_dirty(outpath)

    def load(self, outpath):
        """Point the products at their session files (read on access)."""
        if self.status is Status.DUMPED:
            self.store.point_at(outpath)


class Preprocessing(Step):
    """DCT continuum subtraction, standardization, std local extrema and the
    continuum/residual segmentation maps.

    Parameters: dct_order (DCT atoms, default 10), dct_approx (skip the
    variance weighting), pfasegcont / pfasegres (segmentation PFAs),
    local_max_size (max-filter box), bins (histogram binning).
    """

    name = "preprocessing"
    desc = "Preprocessing"
    products = dict(
        cube_std="cube", cont_dct="cube", ima_std="image", ima_dct="image",
        segmap_cont="image", segmap_merged="image",
        cube_std_local_min="cube", cube_std_local_max="cube",
    )
    forms = dict(cube_std_local_min="sparse", cube_std_local_max="sparse")

    def run(self, orig, dct_order=10, dct_approx=False, pfasegcont=0.01,
            pfasegres=0.01, local_max_size=3, bins="fd"):
        info = self.logger.info
        if orig.shape[0] <= dct_order + 1:
            self.logger.warning(
                "cube has %d channels but the DCT continuum uses %d basis "
                "vectors: the per-spaxel fit is singular and the residual "
                "will be meaningless — lower dct_order",
                orig.shape[0], dct_order + 1,
            )
        info("DCT + standardization + local extrema (on device)")
        with tracing.span("preprocess.device"):
            dev, host = orig.engine.preprocess(dct_order, dct_approx,
                                               local_max_size)
        payload = (host["coef"], host["mean_z"], dct_order)
        for name in ("cube_std", "cube_std_local_max", "cube_std_local_min",
                     "cont_dct"):
            kind = dict(cube_std="dct_std", cont_dct="dct_cont").get(name)
            self.store_cube_dev(
                name, dev.pop(name),
                recipe=kind and self.recipe(kind, payload))
        self.store_image("ima_std", host["ima_std"])
        self.store_image("ima_dct", host["ima_dct"])
        info("cube_std / cont_dct and their images ready")

        with tracing.span("preprocess.segmentation"):
            mean_fwhm = int(np.ceil(np.mean(orig.FWHM_PSF)))

            with np.errstate(divide="ignore"):
                map1 = np.log10(host["cont_sumsq"])
            thresh, map_cont = compute_segmap_gauss(
                map1, pfasegcont, mean_fwhm, bins=bins)
            info("continuum segmentation: %d regions at threshold %.2f",
                 len(np.unique(map_cont)) - 1, thresh)
            self.store_image("segmap_cont", map_cont)

            map2 = host["o2"]
            thresh, map_res = compute_segmap_gauss(
                map2, pfasegres, mean_fwhm, bins=bins)
            info("residual segmentation: %d regions at threshold %.2f",
                 len(np.unique(map_res)) - 1, thresh)

            segmap, nlabels = ndi.label((map_cont > 0) | (map_res > 0))
            info("segmap_merged ready (union of both maps, %d regions)",
                 nlabels)
            self.store_image("segmap_merged", segmap)
        # diagnostics-only product: off the device on a tight session
        orig.engine.maybe_offload("cont_dct")


class CreateAreas(Step):
    """Build the area map that distributes the PCA over zones.

    Parameters: pfa (segmentation PFA), minsize / maxsize (target area side
    in pixels).
    """

    name = "areas"
    desc = "Areas creation"
    products = dict(areamap="image")

    def run(self, orig, pfa=0.2, minsize=100, maxsize=None):
        nexpmap = (np.sum(~orig.mask, axis=0) > 0).astype(int)
        nb_subcube = np.maximum(
            1, int(np.sqrt(np.sum(nexpmap) / (minsize ** 2)))
        )
        if nb_subcube > 1:
            if maxsize is None:
                maxsize = minsize * 2
            min_size2 = minsize ** 2
            max_size2 = maxsize ** 2

            self.logger.info(
                "initial grid segmentation: %d x %d squares",
                nb_subcube, nb_subcube,
            )
            squares = area_segmentation_square_fusion(
                nexpmap, min_size2, max_size2, nb_subcube, orig.Ny, orig.Nx
            )
            self.logger.debug("merging squares with continuum sources")
            fused, src = area_segmentation_sources_fusion(
                orig.segmap_merged.data, squares, pfa, orig.Ny, orig.Nx
            )
            self.logger.debug("convex closure of the source areas")
            convex = area_segmentation_convex_fusion(fused, src)
            if len(convex) == 0:
                # nothing survived the source fusion: keep the square
                # segmentation as the seed instead of one whole-field area
                self.logger.info(
                    "no source areas found; growing the grid segmentation"
                )
                convex = np.asarray(fused)
            if len(convex) == 0:  # no squares either: one area
                areamap = nexpmap
            else:
                self.logger.debug("growing areas over the exposed field")
                grown = area_growing(convex, nexpmap)
                self.logger.debug("absorbing undersized areas")
                areamap = area_segmentation_final(
                    grown, min_size2, max_size2)
        else:
            areamap = nexpmap

        areamap = areamap.astype(np.int64)
        labels = np.unique(areamap)
        nb_areas = len(labels) - 1 if 0 in labels else len(labels)
        orig.param["nbareas"] = nb_areas
        self.store_image("areamap", areamap)
        self.logger.info("areamap ready (%d areas)", nb_areas)


class ComputePCAThreshold(Step):
    """Per-area O2 test and Gaussian-fit threshold for the greedy PCA.

    Parameter: pfa_test (default 0.01).
    """

    name = "compute_PCA_threshold"
    desc = "PCA threshold computation"
    products = dict(thresO2="array", meaO2="array", stdO2="array")
    depends_on = ("preprocessing", "areas")

    def run(self, orig, pfa_test=0.01):
        # O2 map on device (one (Ny, Nx) download); per-area Gaussian fits
        # on the host
        o2map = orig.engine.image_of("cube_std", o2test).astype(np.float64)
        areamap = orig.areamap.data
        results = []
        for area in range(1, orig.nbAreas + 1):
            test = o2map[areamap == area]
            hist, bins, thres, mea, std = compute_thresh_gaussfit(
                test, pfa_test
            )
            results.append((test, hist, bins, thres, mea, std))
            self.logger.info(
                "area %d: mean %f, std %f -> threshold %f",
                area, mea, std, thres,
            )
        (orig.testO2, orig.histO2, orig.binO2, thres, mea, std) = zip(*results)
        orig._o2_files_stale = True  # write() must re-serialize them
        self.put("thresO2", np.asarray(thres))
        self.put("meaO2", np.asarray(mea))
        self.put("stdO2", np.asarray(std))


class ComputeGreedyPCA(Step):
    """Zone-wise greedy PCA nuisance removal.

    Parameters: Noise_population (background fraction denominator), itermax,
    threshold_list (per-area threshold override).
    """

    name = "compute_greedy_PCA"
    desc = "Greedy PCA computation"
    products = dict(cube_faint="cube", mapO2="image")
    depends_on = ("preprocessing", "areas", "compute_PCA_threshold")

    def run(self, orig, Noise_population=50, itermax=100, threshold_list=None):
        thr = orig.thresO2 if threshold_list is None else threshold_list
        orig.param["threshold_list"] = [float(t) for t in thr]
        self.logger.info(
            "per-area thresholds: %s", " ".join("%.2f" % t for t in thr)
        )
        self.logger.info("greedy PCA over the zones (device-resident)")
        faint, mapo2, nstop, factors = orig.engine.greedy_pca_by_area(
            orig.areamap.data, thr, orig.testO2,
            noise_population=Noise_population, itermax=itermax,
        )
        if nstop > 0:
            self.logger.warning(
                "iteration cap (%d) hit in %d zone(s)", itermax, nstop
            )
        # a mesh session's engine records no factors: its cube_faint is
        # written dense, as the JAX package's mesh session writes it
        self.store_cube_dev("cube_faint", faint,
                            recipe=None if factors is None
                            else self.recipe("pca_faint", factors))
        self.store_image("mapO2", mapo2)
        self.logger.info(
            "cube_faint / mapO2 ready (nuisance-removed signal + per-spaxel "
            "iteration counts)"
        )
        # no later device step reads cube_std (its local extrema are
        # products of their own): off the device on a tight session
        orig.engine.maybe_offload("cube_std")


class ComputeTGLR(Step):
    """GLR matched-filter test and its local extrema.

    Parameters: size (max-filter box), ncpu (accepted for API compatibility;
    the device kernel is already data-parallel), pcut (profile trim),
    pmeansub (subtract profile means).
    """

    name = "compute_TGLR"
    desc = "GLR test"
    products = dict(
        cube_correl="cube", cube_correl_min="cube", cube_profile="cube",
        cube_local_min="cube", cube_local_max="cube",
        maxmap="image", minmap="image",
    )
    forms = dict(cube_correl="int16", cube_correl_min="int16",
                 cube_local_min="sparse", cube_local_max="sparse")
    depends_on = ("compute_greedy_PCA",)

    def run(self, orig, size=3, ncpu=1, pcut=1e-8, pmeansub=True):
        self.logger.info("GLR matched filter + local extrema (device-resident)")
        dev, host = orig.engine.tglr(
            orig.PSF, orig.wfields, orig.profiles,
            pcut=pcut, pmeansub=pmeansub, size=size,
        )
        for name in ("cube_correl", "cube_correl_min", "cube_profile",
                     "cube_local_max", "cube_local_min"):
            self.store_cube_dev(name, dev.pop(name))
        self.store_image("maxmap", host["maxmap"])
        self.store_image("minmap", host["minmap"])
        self.logger.info(
            "T_GLR statistic, best-profile indices, local extrema and the "
            "maxmap / minmap images ready"
        )
        orig.engine.maybe_offload("cube_faint", "cube_correl_min")


class ComputePurityThreshold(Step):
    """Self-calibrated detection thresholds for a target purity.

    Parameters: purity, purity_std, threshlist, pfasegfinal, bins.
    """

    name = "compute_purity_threshold"
    desc = "Compute Purity threshold"
    products = dict(Pval="table", Pval_comp="table", segmap_purity="image")
    depends_on = ("compute_TGLR",)

    def run(self, orig, purity=0.9, purity_std=None, threshlist=None,
            pfasegfinal=1e-5, bins="fd"):
        if purity_std is None:
            purity_std = purity
        orig.param.update(dict(purity=purity, purity_std=purity_std))

        with tracing.span("purity.segmap"):
            thresh, map_res = compute_segmap_gauss(
                orig.maxmap.data, pfasegfinal, 0, bins=bins
            )
            segmap, _ = ndi.label((map_res > 0)
                                  | (orig.segmap_merged.data > 0))
        self.store_image("segmap_purity", segmap)

        eng = orig.engine
        threshold, pval, threshold_std, pval_comp = (
            compute_threshold_purity_pair(
                purity, eng.get("cube_local_max"), eng.get("cube_local_min"),
                eng.get("cube_std_local_max"), eng.get("cube_std_local_min"),
                segmap, purity_std=purity_std, threshlist=threshlist,
            )
        )
        self.put("Pval", pval)
        orig.param["threshold"] = threshold
        self.logger.info(
            "correl threshold %.2f for purity %.2f", threshold, purity
        )
        self.put("Pval_comp", pval_comp)
        orig.param["threshold_std"] = threshold_std
        self.logger.info(
            "std threshold %.2f for purity %.2f", threshold_std, purity_std
        )


class Detection(Step):
    """Threshold the local extrema and build the merged line catalog.

    Parameters: threshold / threshold_std (overrides), tol_spat, tol_spec,
    maxdist_lines, segmap (optional user segmentation map path).
    """

    name = "detection"
    desc = "Thresholding and spatio-spectral merging"
    products = dict(Cat0="table", Cat1="table", segmap_label="image")

    def det_correl_min(self, thresh=None):
        """3D positions of detections in correl_min: the ``np.where`` index
        tuple, in C order, of ``cube_local_min > thresh`` (the session's
        correl threshold when ``thresh`` is None), found on the device."""
        if thresh is None:
            thresh = self.orig.param["threshold"]
        zyx, _, _ = self.orig.engine.detections_above("cube_local_min",
                                                      thresh)
        return zyx

    def run(self, orig, threshold=None, threshold_std=None, tol_spat=3,
            tol_spec=5, maxdist_lines=2.5, segmap=None):
        if threshold is not None:
            orig.threshold_correl = threshold
        if threshold_std is not None:
            orig.threshold_std = threshold_std
        if orig.threshold_correl is None or orig.threshold_std is None:
            raise RuntimeError(
                "no detection thresholds available: run "
                "step06_compute_purity_threshold first, or pass "
                "threshold= and threshold_std="
            )

        if segmap is not None:
            self.logger.info("using the provided segmentation map")
            segmap_label = Image(segmap) if isinstance(segmap, str) else segmap
            if segmap_label.shape != orig.shape[1:]:
                raise ValueError(
                    "segmap does not have the same shape as the processed cube"
                )
        else:
            self.logger.info("deblending the continuum segmentation map")
            deb = deblend_sources(
                orig.ima_dct.data, orig.segmap_cont.data, npixels=5,
                mode="linear",
            )
            segmap_label = Image(data=deb, wcs=orig.wcs, copy=False)
        self.put("segmap_label", segmap_label)

        self.logger.info(
            "thresholding correl local maxima (> %.2f)", orig.threshold_correl
        )
        (z, y, x), tglr, (profvals,) = orig.engine.detections_above(
            "cube_local_max", orig.threshold_correl, ("cube_profile",))
        cat = Table(data=[x, y, z], names=("x0", "y0", "z0"))
        cat["comp"] = np.zeros(len(cat), dtype=int)
        cat["STD"] = np.full(len(cat), np.nan)
        cat["T_GLR"] = tglr.astype(float)
        cat["profile"] = profvals.astype(int)
        self.logger.info("%d detected lines", len(cat))

        self.logger.info(
            "thresholding std local maxima (> %.2f)", orig.threshold_std
        )
        (z, y, x), stdvals, _ = orig.engine.detections_above(
            "cube_std_local_max", orig.threshold_std)
        cat_std = Table(data=[x, y, z], names=("x0", "y0", "z0"))
        cat_std["comp"] = np.ones(len(cat_std), dtype=int)
        cat_std["STD"] = stdvals.astype(float)
        cat_std["T_GLR"] = np.full(len(cat_std), np.nan)
        cat_std["profile"] = np.zeros(len(cat_std), dtype=int)
        self.logger.info("%d detected lines", len(cat_std))

        self.put("Cat0", format_catalog(vstack([cat, cat_std])))

        keep = filter_duplicate_lines(cat, cat_std, maxdist_lines)
        cat_std = cat_std[np.asarray(keep, dtype=int)]
        self.logger.info("kept %d lines from std after filtering", len(keep))

        cat = format_catalog(vstack([cat, cat_std]))
        cat["area"] = self.segmap_label.data[
            np.asarray(cat["y0"], int), np.asarray(cat["x0"], int)
        ].astype(int)

        self.logger.info("Spatio-spectral merging...")
        cat = spatiospectral_merging(cat, tol_spat, tol_spec)

        z = np.asarray(cat["z0"])
        y = np.asarray(cat["y0"], float)
        x = np.asarray(cat["x0"], float)
        sky = orig.wcs.pix2sky(np.stack((y, x), axis=1))
        cat.add_column(sky[:, 1], name="ra", index=0)
        cat.add_column(sky[:, 0], name="dec", index=1)
        cat.add_column(orig.wave.coord(z), name="lbda", index=2)
        cat.rename_column("area", "seg_label")

        cat["imatch"] = np.asarray(cat["imatch"]) + 1
        cat["imatch2"] = np.asarray(cat["imatch2"]) + 1

        old_ids = np.unique(cat["imatch"])
        if len(old_ids):
            idmap = np.zeros(old_ids.max() + 1, dtype=int)
            idmap[old_ids] = np.arange(1, len(old_ids) + 1)
            ids = idmap[np.asarray(cat["imatch"])]
        else:  # detection-free field: keep the catalog shape
            ids = np.zeros(0, dtype=int)
        cat.add_column(ids, name="ID", index=0)
        cat.sort("ID")

        pval, pval_comp = orig.Pval, orig.Pval_comp
        if pval is None or pval_comp is None:
            self.logger.warning(
                "no purity curves (step 06 not run): per-line purity "
                "set to NaN"
            )
            cat["purity"] = np.full(len(cat), np.nan)
            cat.set_format("purity", ".3f")
        else:
            self.logger.info("per-line purity estimation")
            cat = purity_estimation(cat, pval, pval_comp)

        cat_comp = cat[np.asarray(cat["comp"]) == 1]
        ns = len(set(np.asarray(cat["ID"])))
        # sources found ONLY by the std (complementary) detection
        cat_glr = cat[np.asarray(cat["comp"]) == 0]
        ds = len(set(np.asarray(cat_comp["ID"]))
                 - set(np.asarray(cat_glr["ID"])))
        self.put("Cat1", cat)
        self.logger.info(
            "Cat1 ready: %d [+%s] sources, %d [+%d] lines",
            ns, ds, len(cat), len(cat_comp),
        )


class ComputeSpectra(Step):
    """Refined line positions, fluxes and deconvolved spectra.

    Parameters: grid_dxy (spatial search radius), spectrum_size_fwhm
    (spectrum trim length in line-FWHM units).
    """

    name = "compute_spectra"
    desc = "Lines estimation"
    products = dict(Cat2="table", spectra="spectra")
    depends_on = ("detection",)

    def run(self, orig, grid_dxy=0, spectrum_size_fwhm=6):
        cat1 = orig.Cat1
        out = estimation_line_arrays(
            np.asarray(cat1["x0"], int),
            np.asarray(cat1["y0"], int),
            np.asarray(cat1["z0"], int),
            # the engine cuts the windows (TorchEngine.cutting_windows)
            None, None, orig.PSF, weights=orig.wfields,
            size_grid=grid_dxy, criteria="flux", order_dct=30, horiz_psf=1,
            horiz=5, engine=orig.engine,
        )
        cat2 = cat1.copy()
        # a line whose estimation failed (all-masked minicube near a cube
        # mask, out-of-bounds refinement) keeps its raw detection position
        # instead of propagating NaN into the catalogs and mask windows
        ok = (np.asarray(out["ok"], bool)
              & np.isfinite(np.asarray(out["x"], float))
              & np.isfinite(np.asarray(out["y"], float)))
        if (~ok).any():
            self.logger.warning(
                "%d line estimation(s) failed; keeping detection "
                "positions (flux = NaN)", int((~ok).sum()),
            )
        out["ok"] = ok
        xr = np.where(ok, out["x"], np.asarray(cat1["x0"], float))
        yr = np.where(ok, out["y"], np.asarray(cat1["y0"], float))
        zr = np.where(ok, out["z"], np.asarray(cat1["z0"]))
        sky = orig.wcs.pix2sky(
            np.stack((yr.astype(float), xr.astype(float)), axis=1)
        )
        cat2["ra"] = sky[:, 1]
        cat2["dec"] = sky[:, 0]
        cat2["lbda"] = orig.wave.coord(zr)
        cat2.add_columns(
            [xr, yr, zr, out["residual"], out["flux"],
             np.arange(1, len(cat2) + 1)],
            names=["x", "y", "z", "residual", "flux", "num_line"],
            indexes=[4, 5, 6, 8, 8, 8],
        )
        format_catalog(cat2)
        self.put("Cat2", cat2)
        self.logger.info("Cat2 ready (%d refined lines)", len(cat2))

        radius = np.ceil(
            np.asarray(orig.FWHM_profiles) * spectrum_size_fwhm / 2
        ).astype(int)
        spectra = OrderedDict()
        for i in range(len(cat2)):
            if not out["ok"][i]:
                continue
            prof = int(np.asarray(cat2["profile"])[i])
            zline = int(out["z"][i])
            num = int(np.asarray(cat2["num_line"])[i])
            sp = Spectrum(
                data=out["line"][i], var=out["line_var"][i], wave=orig.wave,
            )
            spectra[num] = sp.subspec(
                zline - radius[prof], zline + radius[prof]
            )
        self.put("spectra", spectra)
        self.logger.info("per-line deconvolved spectra ready (%d)",
                         len(spectra))


class CleanResults(Step):
    """Merge near-duplicate lines, build the unique-source table and attach
    detection statistics.

    Parameter: merge_lines_z_threshold.
    """

    name = "clean_results"
    desc = "Results cleaning"
    products = dict(Cat3_lines="table", Cat3_sources="table")
    depends_on = ("compute_spectra",)

    def run(self, orig, merge_lines_z_threshold=5):
        lines = merge_similar_lines(
            orig.Cat2, z_pix_threshold=merge_lines_z_threshold
        )
        self.put("Cat3_lines", lines)
        sources = add_tglr_stat(
            unique_sources(lines), lines,
            orig.engine.std_scalar("cube_correl"),
            orig.engine.std_scalar("cube_std"),
        )
        self.put("Cat3_sources", sources)
        self.logger.info(
            "Cat3_sources / Cat3_lines ready (%d sources, %d lines)",
            len(sources), len(lines),
        )
        nmerged = int(np.sum(np.asarray(lines["merged_in"]) != -9999))
        if nmerged:
            self.logger.info("%d lines were merged into nearby lines", nmerged)


class CreateMasks(Step):
    """Write the source mask and sky mask FITS file of every source.

    Parameters: path, overwrite, mask_size, min_sky_npixels,
    seg_thres_factor, fwhm_factor, plot_problems.
    """

    name = "create_masks"
    desc = "Mask creation"
    depends_on = ("clean_results",)

    def run(self, orig, path=None, overwrite=True, mask_size=25,
            min_sky_npixels=100, seg_thres_factor=0.5, fwhm_factor=2,
            plot_problems=False):
        if path is None:
            out_dir = "%s/masks" % orig.outpath
        else:
            # the parent path must EXIST (as in step 11); the reference
            # inverts this check for masks only (reference
            # steps.py:1225-1226 raises when the path exists, making a
            # re-run with the documented overwrite=True impossible)
            if not os.path.exists(path):
                raise ValueError(f"Invalid path: {path}")
            path = os.path.normpath(path)
            out_dir = f"{path}/{orig.name}/masks"

        if overwrite:
            shutil.rmtree(out_dir, ignore_errors=True)
        os.makedirs(out_dir, exist_ok=True)

        orig.param["mask_filename_tpl"] = f"{out_dir}/source-mask-%0.5d.fits"
        orig.param["skymask_filename_tpl"] = f"{out_dir}/sky-mask-%0.5d.fits"

        create_masks(
            line_table=orig.Cat3_lines,
            source_table=orig.Cat3_sources,
            profile_fwhm=orig.FWHM_profiles,
            cube_correl=orig.cube_correl,
            threshold_correl=orig.threshold_correl,
            cube_std=orig.cube_std,
            threshold_std=orig.threshold_std,
            segmap=orig.segmap_label,
            fwhm=orig.LBDA_FWHM_PSF,
            out_dir=out_dir,
            mask_size=mask_size,
            min_sky_npixels=min_sky_npixels,
            seg_thres_factor=seg_thres_factor,
            fwhm_factor=fwhm_factor,
            plot_problems=plot_problems,
        )


class SaveSources(Step):
    """Write one Source FITS file per source.

    Parameters: version (required), path, n_jobs, author, nb_fwhm,
    expmap_filename, overwrite.

    The step ends by writing the session that the sources reference
    (``orig.write()``; its ``cube_correl.fits`` and ``cube_std.fits``).
    """

    name = "save_sources"
    desc = "Save sources"

    def run(self, orig, version, *, path=None, n_jobs=1, author="",
            nb_fwhm=2, expmap_filename=None, overwrite=True):
        # like the reference, this step declares no hard `require` —
        # but fail up front with actionable messages instead of a
        # KeyError mid-build when prerequisites are missing
        if getattr(orig, "Cat3_sources", None) is None:
            raise RuntimeError(
                "no source catalog: run step09_clean_results first"
            )
        if "mask_filename_tpl" not in orig.param:
            raise RuntimeError(
                "no source/sky masks: run step10_create_masks first"
            )

        if path is None:
            outpath = orig.outpath
        else:
            if not os.path.exists(path):
                raise ValueError(f"Invalid path: {path}")
            outpath = os.path.join(os.path.normpath(path), orig.name)
        out_dir = os.path.join(outpath, "sources")

        if overwrite:
            shutil.rmtree(out_dir, ignore_errors=True)
        os.makedirs(out_dir, exist_ok=True)

        # every source's spectra, its lines' narrow-band max images and
        # its detection-cube stats, reduced on the device: the host then
        # skips ~10 cutout-sized passes per source
        with tracing.span("sources.device_rounds"):
            spectra_pre, line_images_pre = self._device_source_artifacts(
                orig, nb_fwhm
            )

        # cube_std feeds only comp=1 (STD-detected) sources' ORI_SNCUBE
        # cutouts
        cat3 = orig.Cat3_sources
        comps = np.asarray(cat3["comp"]) if len(cat3) else np.zeros(0, int)
        spectra = orig.spectra
        create_all_sources(
            cat3_sources=cat3,
            cat3_lines=orig.Cat3_lines,
            origin_params=orig.param,
            cube_cor_filename=os.path.join(outpath, "cube_correl.fits"),
            cube_std_filename=os.path.join(outpath, "cube_std.fits"),
            mask_filename_tpl=orig.param["mask_filename_tpl"],
            skymask_filename_tpl=orig.param["skymask_filename_tpl"],
            spectra_fits_filename=spectra if spectra is not None
            else os.path.join(outpath, "spectra.fits"),
            segmaps={"LABEL": orig.segmap_label,
                     "MERGED": orig.segmap_merged},
            version=version,
            profile_fwhm=orig.FWHM_profiles,
            out_tpl=os.path.join(out_dir, "source-%0.5d.fits"),
            n_jobs=n_jobs,
            author=author,
            nb_fwhm=nb_fwhm,
            expmap_filename=expmap_filename,
            data_cube=orig.cube,
            cube_cor=orig.cube_correl,
            cube_std=orig.cube_std if (comps == 1).any() else None,
            spectra_pre=spectra_pre,
            line_images_pre=line_images_pre,
            wfields=orig.wfields,
        )

        # checkpoint the session the sources reference (the reference
        # writes first, source_creation.py:439; writing last is equivalent
        # on disk).  Stamp this step's own status/meta first: __call__
        # only records them after run() returns, which would leave the
        # written session showing save_sources as NOTRUN on reload
        self.status = Status.RUN
        self.meta["execution_date"] = datetime.now().isoformat()
        if getattr(self, "_span", None) is not None:
            self.meta["runtime"] = self._span.elapsed_s
        orig.write()

    @staticmethod
    def _device_source_artifacts(orig, nb_fwhm):
        """Device-batched spectra + line weight images for every source.

        Returns ``(spectra_pre, line_images_pre)`` for
        :func:`create_all_sources` — or ``(None, None)`` whenever the
        batched path cannot run (a tight-memory session, whose inputs
        left the device; empty catalog; detection cubes not on the
        device), in which case the host per-source path computes
        everything.  Three device rounds: every line's narrow-band max
        image, every source's spectra (the line images as weights), and
        the detection-cube stats (ORI_CORR spectrum, ORI_MAXMAP).
        """
        cat = getattr(orig, "Cat3_sources", None)
        lines = getattr(orig, "Cat3_lines", None)
        if (orig.engine.tight_memory or cat is None or len(cat) == 0
                or lines is None):
            return None, None
        comps_present = {int(c) for c in np.asarray(cat["comp"])}
        dev_by_comp = {}
        for comp, name in ((0, "cube_correl"), (1, "cube_std")):
            obj = getattr(orig, name, None)
            dev_by_comp[comp] = (obj if comp in comps_present
                                 and isinstance(obj, TensorCube) else None)

        mask_tpl = orig.param["mask_filename_tpl"]
        sky_tpl = orig.param["skymask_filename_tpl"]
        wave = orig.wave
        nz = orig.shape[0]
        zstep = wave.get_step()
        profile_fwhm = np.asarray(orig.FWHM_profiles, float)
        unmerged = lines[np.asarray(lines["merged_in"]) == -9999]
        lids = np.asarray(unmerged["ID"])

        jobs_by_size = {}
        img_jobs = {}  # (comp, m) -> [(sid, x, y, [(num, zlo, zhi)])]
        meta = {}
        for row in cat:
            sid = int(row["ID"])
            comp = int(row["comp"])
            if dev_by_comp[comp] is None:
                continue
            try:
                objm = Image(mask_tpl % sid).data > 0
                skym = Image(sky_tpl % sid).data > 0
            except OSError:
                continue
            m = objm.shape[0]
            (y, x), = orig.wcs.sky2pix(
                [[float(row["dec"]), float(row["ra"])]]
            )
            y0, x0 = cutout_window(y, x, m)
            zjobs = []
            for lrow in unmerged[lids == sid]:
                num = int(lrow["num_line"])
                fwhm_ori = profile_fwhm[int(lrow["profile"])] * zstep
                width = nb_fwhm * fwhm_ori
                lbda = float(lrow["lbda"])
                z1 = int(max(0, wave.pixel(lbda - width / 2, nearest=True)))
                z2 = int(min(nz - 1,
                             wave.pixel(lbda + width / 2, nearest=True)))
                zjobs.append((num, z1, z2))
            if not zjobs:
                continue  # host path for line-less sources (defensive)
            img_jobs.setdefault((comp, m), []).append((sid, x, y, zjobs))
            meta[sid] = (m, y0, x0, objm, skym, zjobs, comp)

        if not meta:
            return None, None

        # round 1: every line's narrow-band max image from the resident
        # detection cube (identical values to the host nanmax over the
        # cutout slab; out-of-field pixels zeroed)
        line_images_pre = {}
        for (comp, m), jobs in img_jobs.items():
            got = _fetch_line_images(dev_by_comp[comp], jobs, m)
            for (sid, num), (data, _msk) in got.items():
                line_images_pre[(sid, num)] = np.ascontiguousarray(data)

        # round 2: all spectra, with the line images as weights; in a
        # multi-field session each source's FSF is the fields' models
        # combined at the source (as create_source records it), so the
        # jobs are grouped by cutout size and FSF
        hdr = orig.cube.primary_header
        wcube_fn = None
        fsf_of = {}
        if "FSFMODE" in hdr:
            step_arc = float(orig.wcs.get_step(unit="arcsec")[0])
            models = read_fsf_from_header(hdr, pixstep=step_arc)
            lbda = wave.coord()
            if isinstance(models, list):
                xy = {int(r["ID"]): (r["y"], r["x"]) for r in cat}
                fsf_of = {sid: tuple(field_weights(orig.wfields, *xy[sid]))
                          for sid in meta}
                fsfs = {key: combine_fsf(models, key)
                        for key in set(fsf_of.values())}
            else:
                fsfs = {None: models}

            def wcube_fn(m, key):
                fsf = fsfs[key]
                return _moffat_weight_cube(
                    m, m, step_arc,
                    np.asarray(fsf.get_fwhm(lbda), np.float32),
                    fsf.get_beta(lbda))

        for sid, (m, y0, x0, objm, skym, zjobs, _comp) in meta.items():
            jobs_by_size.setdefault((m, fsf_of.get(sid)), []).append(dict(
                key=sid, y0=y0, x0=x0, objm=objm, skym=skym,
                lines=[(num, line_images_pre[(sid, num)])
                       for num, _z1, _z2 in zjobs
                       if (sid, num) in line_images_pre],
            ))
        spectra_pre = orig.engine.source_spectra(jobs_by_size, wcube_fn)

        # round 3: detection-cube stats (ORI_CORR object-mean spectrum,
        # ORI_MAXMAP) from the same resident cubes, one batch per
        # (cube, size) group
        groups = {}
        for sid, (m, y0, x0, objm, _skym, _zjobs, comp) in meta.items():
            groups.setdefault((comp, m), []).append((sid, y0, x0, objm))
        for (comp, m), rows in groups.items():
            specs, maxmaps = windowed(
                lambda c, y, x, o: window_ori_stats(c, y, x, o, int(m)),
                dev_by_comp[comp].tensor, np.asarray([r[1] for r in rows]),
                int(m), np.asarray([r[2] for r in rows]),
                np.stack([r[3] for r in rows]))
            specs, maxmaps = specs.cpu().numpy(), maxmaps.cpu().numpy()
            for i, (sid, _y0, _x0, _o) in enumerate(rows):
                spectra_pre[sid]["ORI_CORR"] = specs[i]
                spectra_pre[sid]["ORI_MAXMAP_IMG"] = maxmaps[i]
        return (spectra_pre or None), (line_images_pre or None)


STEPS = [
    Preprocessing,
    CreateAreas,
    ComputePCAThreshold,
    ComputeGreedyPCA,
    ComputeTGLR,
    ComputePurityThreshold,
    Detection,
    ComputeSpectra,
    CleanResults,
    CreateMasks,
    SaveSources,
]
