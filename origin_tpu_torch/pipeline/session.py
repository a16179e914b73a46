"""The ORIGIN session for the torch port: steps 01-11 on an explicit device.

Port of :mod:`origin_tpu.pipeline.session`: ``ORIGIN.init``,
``step01_preprocessing`` .. ``step11_save_sources``, and the checkpoint
(``write``, ``load`` and its fork) in the JAX package's session format, so
that a session written by either package loads in the other.  Cube
products are stored in the JAX package's default forms (recipe files for
cube_std, cont_dct and cube_faint, scaled-int16 images for the two
correlation cubes, sparse scaled-int16 tables for the four local-extrema
cubes; see :mod:`.products`), and ``ORIGIN_TPU_STORE_RECIPES=0``,
``ORIGIN_TPU_STORE_INT16=0``, ``ORIGIN_TPU_STORE_SPARSE=0`` and
``ORIGIN_TPU_CORREL_WIRE=f32`` turn them off as there.  A session in the
reference package's dialect (its python-tagged parameter file) loads, and
``write(compat="reference")`` exports one (:mod:`.compat`).  The
reporting methods (``info``, ``status``, ``timestat``, ``stat``) and the
diagnostic plots (:class:`.plotting.PlotMixin`) are the JAX session's.
A fresh single-device session given a file name streams its cube to the
device while the file decodes (:mod:`.ingest`), as the JAX session does.
"""

from __future__ import annotations

import datetime as _dt
import glob
import inspect
import logging
import os
import shutil
import sys
from collections import OrderedDict
from functools import cached_property
from logging.handlers import RotatingFileHandler

import numpy as np

from .. import fitsio, tracing
from ..core.containers import Cube, Image
from ..core.fsf import FieldsMap, read_fsf_from_header
from ..core.profiles import (
    DICO_3FWHM, DICO_FWHM_2_12, default_dictionary_path, load_dictionary,
)
from ..core.table import Table
from ..device import resolve_device
from ..version import version as __version__
from . import compat as compat_mod
from . import ingest as ingest_mod
from . import steps as steps_mod
from .engine import MeshEngine, TorchEngine
from .params import dump_params
from .plotting import PlotMixin
from .steps import Status

__all__ = ["ORIGIN"]

LOGGER_NAME = "origin_tpu_torch"

def setup_logging(name=LOGGER_NAME, level="DEBUG", stream=None,
                  fmt="%(levelname)-05s: %(message)s"):
    """Configure a stream logger."""
    logger = logging.getLogger(name)
    logger.setLevel("DEBUG")
    logger.handlers = [
        h for h in logger.handlers
        if not isinstance(h, logging.StreamHandler)
        or isinstance(h, RotatingFileHandler)
    ]
    handler = logging.StreamHandler(stream or sys.stdout)
    handler.setLevel(level)
    handler.setFormatter(logging.Formatter(fmt))
    logger.addHandler(handler)
    return logger


class ORIGIN(PlotMixin):
    """ORIGIN session: blind emission-line detection on one datacube.

    Composed of the raw cube + variance, a dictionary of spectral profiles
    and the FSF model; drives steps 01-11 (``step01_preprocessing`` ..
    ``step11_save_sources``) on ``device`` (``"cuda"``, or ``"cpu"`` when
    asked for), or with ``mesh`` (a ``(1 x sp)``
    :class:`~origin_tpu_torch.parallel.mesh.Mesh` on that device type)
    row-sharded over its slots (:class:`.engine.MeshEngine`).  ``param``
    is the parameter tree of a loaded session.
    """

    def __init__(self, filename, device="cuda", name="origin", path=".",
                 loglevel="DEBUG", fieldmap=None, profiles=None, PSF=None,
                 LBDA_FWHM_PSF=None, FWHM_PSF=None, PSF_size=25,
                 param=None, imawhite=None, wfields=None, mesh=None):
        self.path = path
        self.mesh = mesh
        self.name = name
        self.outpath = os.path.join(path, name)
        self.param = param or {}
        self.file_handler = None
        # False until THIS session has written its instrument files: a
        # fresh session initialized into a reused directory must
        # overwrite another dataset's cube_psf/ima_white/wfield files,
        # not adopt them (loaded sessions own the existing files)
        self._aux_synced = param is not None
        # resolve the device first: a missing GPU fails before any I/O
        device = resolve_device(device)
        os.makedirs(self.outpath, exist_ok=True)

        setup_logging(level=loglevel, stream=sys.stdout)
        self.logger = logging.getLogger(LOGGER_NAME)
        self._setup_logfile(self.logger)
        self.param["loglevel"] = loglevel
        # the JAX package's load reads it; the port logs without color
        self.param["logcolor"] = False
        self.trace_field = tracing.new_field()
        try:
            with tracing.step_span("init", device, field=self.trace_field):
                self._init_session(filename, device, fieldmap, profiles,
                                   PSF, LBDA_FWHM_PSF, FWHM_PSF, PSF_size,
                                   imawhite, wfields, fresh=param is None)
        except Exception:
            self.close_logfile()
            raise

    def _init_session(self, filename, device, fieldmap, profiles, PSF,
                      LBDA_FWHM_PSF, FWHM_PSF, PSF_size, imawhite, wfields,
                      fresh):
        self.logger.info("Step 00 - Initialization (ORIGIN v%s, torch on %s)",
                         __version__, device)

        # step wiring: instantiate, fix signatures, expose stepNN_* methods
        self.steps = OrderedDict()
        self._product_owner = {}
        for i, cls in enumerate(steps_mod.STEPS, start=1):
            step = cls(self, i, self.param)
            sig = inspect.signature(step.run)
            step.__signature__ = sig.replace(
                parameters=[p for p in sig.parameters.values()
                            if p.name != "orig"]
            )
            self.steps[step.name] = step
            self.__dict__[step.method_name] = step
            for pname in step.store.names():
                self._product_owner[pname] = step

        # a fresh single-device session given a file name streams it: the
        # FITS decode runs in z-slabs and each slab is copied to the device
        # as it is byteswapped (ingest.py); a layout that cannot stream is
        # read eagerly and its copies start right after.  An in-memory
        # Cube, a loaded session and a mesh session upload at step 01.
        plan = None
        cube = filename if isinstance(filename, Cube) else None
        if cube is not None:
            filename = getattr(cube, "filename", None)
        else:
            self.logger.info("Read the Data Cube %s", filename)
            if fresh and self.mesh is None:
                plan = ingest_mod.IngestPlan.scan(filename)
        self.param["cubename"] = filename
        if plan is not None:
            self.Nz, self.Ny, self.Nx = self.shape = plan.shape
            # the engine decides the session's memory mode from the shape
            self.engine = TorchEngine(self, device)
            self.logger.info("ingest: streamed, %d-byte slabs copied to %s "
                             "as they decode", ingest_mod._SLAB_BYTES,
                             self.engine.device)
            self.cube = self.engine.stream_inputs(plan)
        else:
            self.cube = cube if cube is not None else Cube(filename)
            self.Nz, self.Ny, self.Nx = self.shape = self.cube.shape
            # a bad mesh fails here
            self.engine = (TorchEngine(self, device) if self.mesh is None
                           else MeshEngine(self, self.mesh, device))
            if fresh and self.mesh is None and cube is None:
                self.logger.info("ingest: eager read, copies to %s started",
                                 self.engine.device)
                self.engine.prefetch_inputs()
        self.wcs = self.cube.wcs
        self.wave = self.cube.wave

        if profiles is None:
            profiles = default_dictionary_path()
        self.param["profiles"] = profiles
        self.param["fieldmap"] = fieldmap
        self.param["PSF_size"] = PSF_size
        with tracing.span("ingest.fsf"):
            self._read_fsf(
                self.cube, fieldmap=fieldmap, wfields=wfields, PSF=PSF,
                LBDA_FWHM_PSF=LBDA_FWHM_PSF, FWHM_PSF=FWHM_PSF,
                PSF_size=PSF_size,
            )

        with tracing.span("ingest.white"):
            self.ima_white = imawhite if imawhite else self.cube.mean(axis=0)
        self.testO2, self.histO2, self.binO2 = None, None, None
        self._o2_files_stale = True
        self.logger.info("Step 00 finished")

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        owners = self.__dict__.get("_product_owner", {})
        if name in owners:
            return getattr(owners[name], name)
        raise AttributeError(f"unknown attribute {name}")

    def __dir__(self):
        return (
            list(super().__dir__())
            + list(self._product_owner.keys())
            + [s.method_name for s in self.steps.values()]
        )

    # -- raw data views ------------------------------------------------------
    @cached_property
    def cube_raw(self):
        return self.cube.filled(0).astype(np.float32, copy=False)

    @cached_property
    def mask(self):
        return self.cube.masked_invalid()

    @cached_property
    def var(self):
        var = self.cube.var_filled(np.inf)
        if var is None:
            var = np.ones(self.shape, dtype=np.float32)
        return var.astype(np.float32, copy=False)

    # -- constructors --------------------------------------------------------
    @classmethod
    def init(cls, cube, fieldmap=None, profiles=None, PSF=None,
             LBDA_FWHM_PSF=None, FWHM_PSF=None, PSF_size=25, name="origin",
             path=".", loglevel="DEBUG", device="cuda", mesh=None):
        """Create a session from a cube FITS file (or a ``Cube``).

        ``device`` is explicit: ``"cuda"`` (the default) raises when torch
        sees no GPU; ``"cpu"`` runs the plain torch versions on the CPU.
        ``mesh`` (optional): a ``(1 x sp)`` mesh of that device type
        (``origin_tpu_torch.parallel.make_mesh(n, dp=1)``, or ``devices=
        ["cpu"] * n``); the session's cubes then live row-sharded over its
        slots.
        """
        return cls(
            cube, device=device, path=path, name=name, fieldmap=fieldmap,
            profiles=profiles, PSF=PSF, LBDA_FWHM_PSF=LBDA_FWHM_PSF,
            FWHM_PSF=FWHM_PSF, PSF_size=PSF_size, loglevel=loglevel,
            mesh=mesh,
        )

    @classmethod
    def load(cls, folder, newname=None, loglevel=None, device="cuda",
             mesh=None):
        """Restore a saved session, written by this package, by the JAX
        package or by the reference package (its python-tagged parameter
        file is decoded, :mod:`.compat`); optionally fork it under a new
        name.

        ``device`` is explicit, as for :meth:`init`.  The cube products
        come back on it at their first fetch.  A mesh is runtime state,
        not session state: pass ``mesh=`` again to resume a row-sharded
        session (the files are the same with or without one).
        """
        import yaml

        resolve_device(device)  # a missing GPU fails before any I/O
        path = os.path.dirname(os.path.abspath(folder))
        name = os.path.basename(folder)

        with open(f"{folder}/{name}.yaml") as stream:
            text = stream.read()
        if compat_mod.looks_like_reference_yaml(text):
            # the reference's python-tagged dialect, decoded into this
            # schema (its product files have the same names)
            param = compat_mod.loads_params(text)
        else:
            param = yaml.safe_load(text)
        if param.get("cubename") is None:
            raise ValueError(
                f"session {folder} was made from an in-memory Cube "
                "(cubename: null): it cannot be loaded without its cube file"
            )

        # convert step status strings back into enums
        for val in param.values():
            if isinstance(val, dict) and "status" in val:
                val["status"] = Status[val["status"]]

        # a session moved from another machine, or written by the JAX
        # package, may name a profile dictionary that is not here; the
        # two shipped dictionaries are also shipped with the port
        prof = param.get("profiles")
        if prof and not os.path.isfile(str(prof)):
            base = os.path.basename(str(prof))
            if base in (DICO_3FWHM, DICO_FWHM_2_12):
                packaged = default_dictionary_path(base)
                logging.getLogger(LOGGER_NAME).warning(
                    "profile dictionary %s not found; using the packaged %s",
                    prof, packaged,
                )
                param["profiles"] = packaged

        FWHM_PSF = (
            np.asarray(param["FWHM PSF"]) if "FWHM PSF" in param else None
        )
        LBDA_FWHM_PSF = (
            np.asarray(param["LBDA FWHM PSF"])
            if "LBDA FWHM PSF" in param else None
        )

        if param.get("PSF") and os.path.isfile(str(param["PSF"])):
            PSF = param["PSF"]
        elif os.path.isfile("%s/cube_psf.fits" % folder):
            PSF = "%s/cube_psf.fits" % folder
        else:
            files = glob.glob("%s/cube_psf_*.fits" % folder)
            PSF = (
                None if len(files) == 0
                else files[0] if len(files) == 1 else sorted(files)
            )
        wfield_files = sorted(glob.glob("%s/wfield_*.fits" % folder))
        wfields = wfield_files if wfield_files else None

        ima_white = (
            Image("%s/ima_white.fits" % folder)
            if os.path.isfile("%s/ima_white.fits" % folder) else None
        )

        if newname is not None:
            shutil.copytree(os.path.join(path, name),
                            os.path.join(path, newname))
            name = newname

        loglevel = loglevel if loglevel is not None else param["loglevel"]

        obj = cls(
            param["cubename"], device=device, path=path, name=name,
            param=param, imawhite=ima_white, loglevel=loglevel,
            fieldmap=param.get("fieldmap"), wfields=wfields,
            profiles=param["profiles"], PSF=PSF, FWHM_PSF=FWHM_PSF,
            LBDA_FWHM_PSF=LBDA_FWHM_PSF, PSF_size=param.get("PSF_size", 25),
            mesh=mesh,
        )

        for step in obj.steps.values():
            step.load(obj.outpath)

        nb_areas = param.get("nbareas")
        if nb_areas is not None:
            for attr in ("testO2", "histO2", "binO2"):
                if os.path.isfile("%s/%s_1.txt" % (folder, attr)):
                    setattr(obj, attr, [
                        np.loadtxt("%s/%s_%d.txt" % (folder, attr, a), ndmin=1)
                        for a in range(1, nb_areas + 1)
                    ])
                    obj._o2_files_stale = False  # just read from those files
        return obj

    # -- checkpointing -------------------------------------------------------
    def write(self, path=None, erase=False, compat=None):
        """Dump the whole session (every step product + parameters) into
        ``<path or self.path>/<self.name>``.

        ``path`` moves the session there (copying its folder); ``erase``
        deletes the folder first.  Every cube product is written in its
        form (see :mod:`.products`), and parking it frees its device
        memory.

        With ``compat='reference'`` the session is instead exported in the
        reference package's dialect (dense standard FITS products and its
        python-tagged parameter file) into ``<path or self.path>/<name>``,
        whose path is returned (see
        :func:`.compat.export_reference_session`); the session itself is
        not moved.
        """
        with tracing.span("session.write", field=self.trace_field):
            return self._write(path, erase, compat)

    def _write(self, path, erase, compat):
        if compat is not None:
            if compat != "reference":
                raise ValueError(f"unknown compat dialect: {compat!r}")
            folder = os.path.join(path or self.path, self.name)
            self.logger.info("Exporting reference-dialect session to %s",
                             folder)
            return compat_mod.export_reference_session(self, folder)
        self.logger.info("Writing...")
        if path is not None and path != self.path:
            if not os.path.exists(path):
                raise ValueError(f"path does not exist: {path}")
            self.path = path
            outpath = os.path.join(path, self.name)
            shutil.copytree(self.outpath, outpath)
            for step in self.steps.values():
                step.store.move(self.outpath, outpath)
            self.outpath = outpath
            self.close_logfile()
            self._setup_logfile(self.logger)
        reopen_log = False
        if erase:
            # the parked products live in the folder: read them back
            # first, so that the dump below writes every product again
            # (the JAX package loses them here)
            for step in self.steps.values():
                step.store.hold_all()
            # the rotating-file handler holds <name>.log inside the tree:
            # close it before the rmtree and reopen it after the directory
            # is recreated
            if self.file_handler is not None:
                self.close_logfile()
                reopen_log = True
            shutil.rmtree(self.outpath)
            self._o2_files_stale = True
        os.makedirs(self.outpath, exist_ok=True)
        if reopen_log:
            self._setup_logfile(self.logger)

        # the instrument files never change within a session: write them
        # only when they are not already on disk
        def _write_once(obj, fname):
            target = os.path.join(self.outpath, fname)
            if not self._aux_synced or not os.path.isfile(target):
                obj.write(target)

        if isinstance(self.PSF, list):
            for i, psf in enumerate(self.PSF):
                _write_once(Cube(data=psf, mask=False),
                            "cube_psf_%02d.fits" % i)
        else:
            _write_once(Cube(data=self.PSF, mask=False), "cube_psf.fits")
        if self.wfields is not None:
            for i, wfield in enumerate(self.wfields):
                _write_once(Image(data=np.asarray(wfield), mask=False),
                            "wfield_%02d.fits" % i)
        if self.ima_white is not None:
            _write_once(self.ima_white, "ima_white.fits")
        self._aux_synced = True  # subsequent write()s skip the rewrites

        for step in self.steps.values():
            step.dump(self.outpath)

        with open(f"{self.outpath}/{self.name}.yaml", "w") as stream:
            stream.write(dump_params(self.param))

        # per-area O2 diagnostics: rewritten only when step 03 recomputed
        # them
        if self.nbAreas is not None and self._o2_files_stale:
            wrote = False
            for attr in ("testO2", "histO2", "binO2"):
                values = getattr(self, attr)
                if values is not None:
                    wrote = True
                    for area in range(1, self.nbAreas + 1):
                        np.savetxt(
                            "%s/%s_%d.txt" % (self.outpath, attr, area),
                            values[area - 1],
                        )
            if wrote:
                self._o2_files_stale = False
        self.logger.info("Current session saved in %s", self.outpath)

    # -- logging / reporting -------------------------------------------------
    def info(self):
        """Print the processing log (without the step-completion lines)."""
        with open(self.logfile) as f:
            for line in f:
                if "finished" not in line:
                    print(line, end="")

    def status(self):
        """Print the processing status of every step."""
        for name, step in self.steps.items():
            print(f"- {step.idx:02d}, {name}: {step.status.name}")

    def set_loglevel(self, level):
        """Set the console logging level."""
        handler = next(
            h for h in self.logger.handlers
            if isinstance(h, logging.StreamHandler)
            and not isinstance(h, RotatingFileHandler)
        )
        handler.setLevel(level)
        self.param["loglevel"] = level

    def _setup_logfile(self, logger):
        self.logfile = os.path.join(self.outpath, self.name + ".log")
        self.file_handler = RotatingFileHandler(self.logfile, "a", 1000000, 1)
        self.file_handler.setLevel(logging.DEBUG)
        self.file_handler.setFormatter(
            logging.Formatter("%(asctime)s %(message)s")
        )
        logger.addHandler(self.file_handler)

    def close_logfile(self):
        """Close and detach this session's rotating logfile handler."""
        if self.file_handler is not None:
            self.file_handler.close()
            if self.file_handler in self.logger.handlers:
                self.logger.handlers.remove(self.file_handler)
            self.file_handler = None

    # -- summaries -----------------------------------------------------------
    def timestat(self, table=False):
        """Runtime per step; returns a Table when ``table`` is True."""
        if table:
            names, exdates, extimes = [], [], []
            tot = 0.0
            for step in self.steps.values():
                if "execution_date" in step.meta:
                    names.append(step.method_name)
                    exdates.append(step.meta["execution_date"])
                    t = step.meta["runtime"]
                    tot += t
                    extimes.append(str(_dt.timedelta(seconds=t)))
            names.append("Total")
            exdates.append("")
            extimes.append(str(_dt.timedelta(seconds=tot)))
            return Table(data=[names, exdates, extimes],
                         names=["Step", "Exec Date", "Exec Time"])
        tot = 0.0
        for step in self.steps.values():
            if "execution_date" in step.meta:
                t = step.meta["runtime"]
                tot += t
                self.logger.info(
                    "%s executed: %s run time: %s", step.method_name,
                    step.meta["execution_date"], str(_dt.timedelta(seconds=t)),
                )
        self.logger.info(
            "*** Total run time: %s", str(_dt.timedelta(seconds=tot))
        )

    def stat(self):
        """Log the detection summary."""
        d = self._get_stat()
        self.logger.info(
            "ORIGIN PCA pfa %.2f Back Purity: %.2f Threshold: %.2f "
            "Bright Purity %.2f Threshold %.2f",
            d["pca"], d["back_purity"], d["back_threshold"],
            d["bright_purity"], d["bright_threshold"],
        )
        self.logger.info("Nb of detected lines: %d", d["tot_nlines"])
        self.logger.info(
            "Nb of sources Total: %d Background: %d Cont: %d",
            d["tot_nsources"], d["back_nsources"], d["cont_nsources"],
        )
        self.logger.info(
            "Nb of sources detected in faint (after PCA): %d "
            "in std (before PCA): %d",
            d["faint_nsources"], d["bright_nsources"],
        )

    def _get_stat(self):
        p = self.param
        cat = self.Cat3_sources
        seg = np.asarray(cat["seg_label"])
        comp = np.asarray(cat["comp"])
        return dict(
            pca=p["compute_PCA_threshold"]["params"]["pfa_test"],
            back_purity=p["purity"],
            back_threshold=p["threshold"],
            bright_purity=p["purity_std"],
            bright_threshold=p["threshold_std"],
            tot_nlines=len(self.Cat3_lines),
            tot_nsources=len(cat),
            back_nsources=int(np.sum(seg == 0)),
            cont_nsources=int(np.sum(seg > 0)),
            faint_nsources=int(np.sum(comp == 0)),
            bright_nsources=int(np.sum(comp == 1)),
        )

    # -- parameters ---------------------------------------------------------
    @property
    def nbAreas(self):
        """Number of areas for the zone-wise PCA."""
        return self.param.get("nbareas")

    @property
    def threshold_correl(self):
        """Detection threshold on the max-correlation local maxima."""
        return self.param.get("threshold")

    @threshold_correl.setter
    def threshold_correl(self, value):
        self.param["threshold"] = value

    @property
    def threshold_std(self):
        """Detection threshold on the std-cube local maxima."""
        return self.param.get("threshold_std")

    @threshold_std.setter
    def threshold_std(self, value):
        self.param["threshold_std"] = value

    @cached_property
    def profiles(self):
        """The spectral line profiles."""
        path = self.param["profiles"]
        self.logger.info("Load dictionary of spectral profile %s", path)
        profiles, _ = load_dictionary(path)
        return profiles

    @cached_property
    def FWHM_profiles(self):
        """FWHM of the spectral profiles, in pixels."""
        _, fwhms = load_dictionary(self.param["profiles"])
        return fwhms

    # -- FSF -------------------------------------------------------------------
    def _read_fsf(self, cube, fieldmap=None, wfields=None, PSF=None,
                  LBDA_FWHM_PSF=None, FWHM_PSF=None, PSF_size=25):
        self.wfields = None
        info = self.logger.info

        if PSF is None or FWHM_PSF is None or LBDA_FWHM_PSF is None:
            info("Compute FSFs from the datacube FITS header keywords")
            pixstep = cube.wcs.get_step(unit="arcsec")[0] if cube.wcs else 0.2
            fsf = read_fsf_from_header(cube.primary_header, pixstep=pixstep)
            lbda = cube.wave.coord()
            shape = (PSF_size, PSF_size)
            if not isinstance(fsf, list):
                self.PSF = fsf.get_3darray(lbda, shape).astype(np.float32)
                self.LBDA_FWHM_PSF = fsf.get_fwhm(lbda, unit="pix")
                self.FWHM_PSF = float(np.mean(self.LBDA_FWHM_PSF))
                info("mean FWHM of the FSFs = %.2f pixels", self.FWHM_PSF)
            else:
                self.PSF = [
                    f.get_3darray(lbda, shape).astype(np.float32) for f in fsf
                ]
                fwhm = np.array([f.get_fwhm(lbda, unit="pix") for f in fsf])
                self.LBDA_FWHM_PSF = np.mean(fwhm, axis=0)
                self.FWHM_PSF = np.mean(fwhm, axis=1)
                for i, fw in enumerate(self.FWHM_PSF):
                    info("mean FWHM of the FSFs (field %d) = %.2f pixels",
                         i, fw)
                info("Compute weight maps from field map %s", fieldmap)
                fmap = FieldsMap(fieldmap, nfields=len(fsf))
                self.wfields = fmap.compute_weights()
            self.param["PSF"] = cube.primary_header.get("FSFMODE", "header")
        else:
            self.LBDA_FWHM_PSF = np.asarray(LBDA_FWHM_PSF)
            if isinstance(PSF, str):
                info("Load FSFs from %s", PSF)
                self.param["PSF"] = PSF
                self.PSF = fitsio.getdata(PSF).astype(np.float32)
                if self.PSF.shape[1] != self.PSF.shape[2]:
                    raise ValueError("PSF must be a square image.")
                if not self.PSF.shape[1] % 2:
                    raise ValueError("The spatial size of the PSF must be odd.")
                if self.PSF.shape[0] != self.shape[0]:
                    raise ValueError(
                        "PSF and data cube have not the same dimensions "
                        "along the spectral axis."
                    )
                self.FWHM_PSF = float(np.mean(FWHM_PSF))
                info("mean FWHM of the FSFs = %.2f pixels", self.FWHM_PSF)
            else:
                nfields = len(PSF)
                self.wfields = []
                self.PSF = []
                self.FWHM_PSF = list(np.asarray(FWHM_PSF))
                for n in range(nfields):
                    info("Load FSF from %s", PSF[n])
                    self.PSF.append(fitsio.getdata(PSF[n]).astype(np.float32))
                    info("Load weight maps from %s", wfields[n])
                    self.wfields.append(fitsio.getdata(wfields[n]))
                    info("mean FWHM of the FSFs (field %d) = %.2f pixels",
                         n, FWHM_PSF[n])

        self.param["FWHM PSF"] = np.asarray(self.FWHM_PSF).tolist()
        self.param["LBDA FWHM PSF"] = np.asarray(self.LBDA_FWHM_PSF).tolist()
