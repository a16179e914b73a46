"""The ORIGIN session for the torch port: steps 01-07 on an explicit device.

Port of the step wiring of :mod:`origin_tpu.pipeline.session`
(``ORIGIN.init`` and ``step01_preprocessing`` .. ``step07_detection``).
Session write/load and steps 08-11 are not ported yet and raise
:class:`NotImplementedError` naming their ROADMAP.md item.
"""

from __future__ import annotations

import inspect
import logging
import os
import sys
from collections import OrderedDict
from functools import cached_property
from logging.handlers import RotatingFileHandler

import numpy as np

from origin_tpu import fitsio
from origin_tpu.core.containers import Cube
from origin_tpu.core.fsf import FieldsMap, read_fsf_from_header
from origin_tpu.core.profiles import default_dictionary_path, load_dictionary
from origin_tpu.version import version as __version__

from . import steps as steps_mod
from .engine import TorchEngine

__all__ = ["ORIGIN"]

LOGGER_NAME = "origin_tpu_torch"

#: ROADMAP.md section 1 items that port what is not here yet
_LATER = {
    "step08_compute_spectra": "Step 08: line estimation",
    "step09_clean_results": "Steps 09-11: cleaning, masks and sources",
    "step10_create_masks": "Steps 09-11: cleaning, masks and sources",
    "step11_save_sources": "Steps 09-11: cleaning, masks and sources",
    "write": "Session I/O",
    "load": "Session I/O",
}


def _not_ported(name):
    return NotImplementedError(
        f"{name} is not ported to origin_tpu_torch yet (ROADMAP.md, "
        f"section 1: '{_LATER[name]}'); use origin_tpu for it"
    )


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


class ORIGIN:
    """ORIGIN session: blind emission-line detection on one datacube.

    Composed of the raw cube + variance, a dictionary of spectral profiles
    and the FSF model; drives steps 01-07 (``step01_preprocessing`` ..
    ``step07_detection``) on ``device`` (``"cuda"``, or ``"cpu"`` when
    asked for).
    """

    def __init__(self, filename, device="cuda", name="origin", path=".",
                 loglevel="DEBUG", fieldmap=None, profiles=None, PSF=None,
                 LBDA_FWHM_PSF=None, FWHM_PSF=None, PSF_size=25,
                 imawhite=None, wfields=None):
        self.path = path
        self.name = name
        self.outpath = os.path.join(path, name)
        self.param = {}
        self.file_handler = None
        # resolve the device first: a missing GPU fails before any I/O
        self.engine = TorchEngine(self, device)
        os.makedirs(self.outpath, exist_ok=True)

        setup_logging(level=loglevel, stream=sys.stdout)
        self.logger = logging.getLogger(LOGGER_NAME)
        self._setup_logfile(self.logger)
        self.param["loglevel"] = loglevel
        try:
            self._init_session(filename, fieldmap, profiles, PSF,
                               LBDA_FWHM_PSF, FWHM_PSF, PSF_size, imawhite,
                               wfields)
        except Exception:
            self.close_logfile()
            raise

    def _init_session(self, filename, fieldmap, profiles, PSF,
                      LBDA_FWHM_PSF, FWHM_PSF, PSF_size, imawhite, wfields):
        self.logger.info("Step 00 - Initialization (ORIGIN v%s, torch on %s)",
                         __version__, self.engine.device)

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

        if isinstance(filename, Cube):
            self.cube = filename
            filename = getattr(filename, "filename", None)
        else:
            self.logger.info("Read the Data Cube %s", filename)
            self.cube = Cube(filename)
        self.param["cubename"] = filename
        self.Nz, self.Ny, self.Nx = self.shape = self.cube.shape
        self.wcs = self.cube.wcs
        self.wave = self.cube.wave

        if profiles is None:
            profiles = default_dictionary_path()
        self.param["profiles"] = profiles
        self.param["fieldmap"] = fieldmap
        self.param["PSF_size"] = PSF_size
        self._read_fsf(
            self.cube, fieldmap=fieldmap, wfields=wfields, PSF=PSF,
            LBDA_FWHM_PSF=LBDA_FWHM_PSF, FWHM_PSF=FWHM_PSF, PSF_size=PSF_size,
        )

        self.ima_white = imawhite if imawhite else self.cube.mean(axis=0)
        self.testO2, self.histO2, self.binO2 = None, None, None
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
             path=".", loglevel="DEBUG", device="cuda"):
        """Create a session from a cube FITS file (or a ``Cube``).

        ``device`` is explicit: ``"cuda"`` (the default) raises when torch
        sees no GPU; ``"cpu"`` runs the plain torch versions on the CPU.
        """
        return cls(
            cube, device=device, path=path, name=name, fieldmap=fieldmap,
            profiles=profiles, PSF=PSF, LBDA_FWHM_PSF=LBDA_FWHM_PSF,
            FWHM_PSF=FWHM_PSF, PSF_size=PSF_size, loglevel=loglevel,
        )

    @classmethod
    def load(cls, folder, newname=None, loglevel=None, device="cuda"):
        raise _not_ported("load")

    def write(self, path=None, erase=False, compat=None):
        raise _not_ported("write")

    def step08_compute_spectra(self, *args, **kwargs):
        raise _not_ported("step08_compute_spectra")

    def step09_clean_results(self, *args, **kwargs):
        raise _not_ported("step09_clean_results")

    def step10_create_masks(self, *args, **kwargs):
        raise _not_ported("step10_create_masks")

    def step11_save_sources(self, *args, **kwargs):
        raise _not_ported("step11_save_sources")

    # -- logging -------------------------------------------------------------
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
