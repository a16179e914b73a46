"""Steps 01-07 of the pipeline and the stage protocol that drives them.

Port of the front-end steps of :mod:`origin_tpu.pipeline.steps`: the same
parameters, products and host logic, with the cube-sized math on the
session's torch device (:class:`.engine.TorchEngine`).  Steps 08-11 are
not ported yet (see ROADMAP.md).
"""

from __future__ import annotations

import inspect
import logging
import time
from datetime import datetime
from enum import Enum, auto

import numpy as np
from scipy import ndimage as ndi

from origin_tpu.core.containers import Image
from origin_tpu.core.table import Table, vstack

from ..detect import (
    area_growing,
    area_segmentation_convex_fusion,
    area_segmentation_final,
    area_segmentation_sources_fusion,
    area_segmentation_square_fusion,
    compute_segmap_gauss,
    deblend_sources,
    filter_duplicate_lines,
    purity_estimation,
    spatiospectral_merging,
)
from ..ops.purity import compute_threshold_purity_pair
from ..ops.stats import compute_thresh_gaussfit, o2test
from .products import ProductStore, TensorCube, format_catalog

__all__ = [
    "Preprocessing",
    "CreateAreas",
    "ComputePCAThreshold",
    "ComputeGreedyPCA",
    "ComputeTGLR",
    "ComputePurityThreshold",
    "Detection",
    "Status",
    "Step",
    "STEPS",
]


class Status(Enum):
    """Lifecycle of a step within a session: NOTRUN -> RUN, or FAILED if
    ``run`` raised."""

    NOTRUN = auto()
    RUN = auto()
    FAILED = auto()


class Step:
    """One pipeline stage bound to an ORIGIN session.

    Subclasses declare ``name`` / ``desc``, ``products`` (product name ->
    kind) and ``depends_on``, and implement ``run(orig, **params)``.
    Calling the step records its effective parameters, checks its
    dependencies, times the run and tracks a :class:`Status`.  Products are
    published with :meth:`put` and read back as attributes.
    """

    name = ""
    desc = ""
    products = {}
    depends_on = ()

    def __init__(self, orig, idx, param):
        self.logger = logging.getLogger(__name__)
        self.orig = orig
        self.idx = idx
        self.method_name = f"step{idx:02d}_{self.name}"
        self.store = ProductStore(self.products)
        meta = param.setdefault(self.name, {})
        meta.setdefault("stepidx", idx)
        self.meta = meta
        self.param = meta.setdefault("params", {})

    def __repr__(self):
        return (
            f"<{type(self).__name__} [{self.idx:02d}] {self.status.name}>"
        )

    def __getattr__(self, name):
        store = self.__dict__.get("store")
        if store is not None and name in store:
            return store.peek(name)
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
            if dep.status is not Status.RUN:
                raise RuntimeError(
                    f"{self.method_name} requires {dep.method_name} "
                    f"(status: {dep.status.name})"
                )

    def __call__(self, *args, **kwargs):
        self.logger.info("Step %02d - %s", self.idx, self.desc)
        t0 = time.perf_counter()
        self._record_params(args, kwargs)
        self._check_dependencies()
        try:
            self.run(self.orig, *args, **kwargs)
        except Exception:
            self.status = Status.FAILED
            raise
        self.status = Status.RUN
        self.meta["runtime"] = elapsed = time.perf_counter() - t0
        self.meta["execution_date"] = datetime.now().isoformat()
        self.logger.info("Step %02d finished (%.2f s)", self.idx, elapsed)

    def put(self, name, value):
        """Publish a product (must be declared in ``products``)."""
        self.store.stash(name, value)

    def store_cube_dev(self, name, tensor):
        """Publish a device-resident cube product."""
        self.put(name, TensorCube(tensor, wcs=self.orig.wcs,
                                  wave=self.orig.wave))

    def store_image(self, name, data, **kwargs):
        self.put(name, Image(data=data, wcs=self.orig.wcs, mask=False,
                             copy=False, **kwargs))


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
        dev, host = orig.engine.preprocess(dct_order, dct_approx,
                                           local_max_size)
        for name in ("cube_std", "cube_std_local_max", "cube_std_local_min",
                     "cont_dct"):
            self.store_cube_dev(name, dev[name])
        self.store_image("ima_std", host["ima_std"])
        self.store_image("ima_dct", host["ima_dct"])
        info("cube_std / cont_dct and their images ready")

        mean_fwhm = int(np.ceil(np.mean(orig.FWHM_PSF)))

        with np.errstate(divide="ignore"):
            map1 = np.log10(host["cont_sumsq"])
        thresh, map_cont = compute_segmap_gauss(map1, pfasegcont, mean_fwhm,
                                                bins=bins)
        info("continuum segmentation: %d regions at threshold %.2f",
             len(np.unique(map_cont)) - 1, thresh)
        self.store_image("segmap_cont", map_cont)

        map2 = host["o2"]
        thresh, map_res = compute_segmap_gauss(map2, pfasegres, mean_fwhm,
                                               bins=bins)
        info("residual segmentation: %d regions at threshold %.2f",
             len(np.unique(map_res)) - 1, thresh)

        segmap, nlabels = ndi.label((map_cont > 0) | (map_res > 0))
        info("segmap_merged ready (union of both maps, %d regions)", nlabels)
        self.store_image("segmap_merged", segmap)


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
        o2map = o2test(orig.engine.get("cube_std")).cpu().numpy().astype(
            np.float64
        )
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
        faint, mapo2, nstop = orig.engine.greedy_pca_by_area(
            orig.areamap.data, thr, orig.testO2,
            noise_population=Noise_population, itermax=itermax,
        )
        if nstop > 0:
            self.logger.warning(
                "iteration cap (%d) hit in %d zone(s)", itermax, nstop
            )
        self.store_cube_dev("cube_faint", faint)
        self.store_image("mapO2", mapo2)
        self.logger.info(
            "cube_faint / mapO2 ready (nuisance-removed signal + per-spaxel "
            "iteration counts)"
        )


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
    depends_on = ("compute_greedy_PCA",)

    def run(self, orig, size=3, ncpu=1, pcut=1e-8, pmeansub=True):
        self.logger.info("GLR matched filter + local extrema (device-resident)")
        dev, host = orig.engine.tglr(
            orig.PSF, orig.wfields, orig.profiles,
            pcut=pcut, pmeansub=pmeansub, size=size,
        )
        for name in ("cube_correl", "cube_correl_min", "cube_profile",
                     "cube_local_max", "cube_local_min"):
            self.store_cube_dev(name, dev[name])
        self.store_image("maxmap", host["maxmap"])
        self.store_image("minmap", host["minmap"])
        self.logger.info(
            "T_GLR statistic, best-profile indices, local extrema and the "
            "maxmap / minmap images ready"
        )


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

        thresh, map_res = compute_segmap_gauss(
            orig.maxmap.data, pfasegfinal, 0, bins=bins
        )
        segmap, _ = ndi.label((map_res > 0) | (orig.segmap_merged.data > 0))
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


STEPS = [
    Preprocessing,
    CreateAreas,
    ComputePCAThreshold,
    ComputeGreedyPCA,
    ComputeTGLR,
    ComputePurityThreshold,
    Detection,
]
