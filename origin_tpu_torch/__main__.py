"""Command-line interface: ``python -m origin_tpu_torch <command>``.

The port's copy of :mod:`origin_tpu.__main__`, a thin batch front door
over the session API, with the same commands, arguments and exit codes,
and ``--device`` (``cuda`` by default, ``cpu`` when asked for), which is
passed to ``ORIGIN.init`` / ``ORIGIN.load``.  A missing GPU fails before
any session folder is made.

Commands
--------
run      run the full 11-step pipeline on a cube (several cubes: one
         session each, ``<name>-<stem>``; a failed cube does not stop the
         rest, and the command then exits 1 with the list on stderr)
resume   resume a saved session, running any remaining steps
status   print a saved session's step status / timings / stats
info     print a saved session's log

``--mesh N`` row-shards a session over the first N GPUs
(``make_mesh(N, dp=1)``; it raises when torch sees fewer), or with
``--device cpu`` over N CPU slots.  ``--overlap-ingest`` pipelines a
survey: the next field's session is initialized (its FITS decode and its
copies to the device) before the current field's steps run, so two
fields' raw inputs are on the device at once.
"""

from __future__ import annotations

import argparse
import gc
import logging
import os
import sys


def _add_device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device of the session: cuda (the default; "
                   "fails without a GPU) or cpu")


def _add_session_args(p):
    p.add_argument("--name", default="origin", help="session name")
    p.add_argument("--path", default=".", help="session parent directory")
    p.add_argument("--loglevel", default="INFO")


def _add_run_args(p):
    p.add_argument("--profiles", default=None,
                   help="spectral profile dictionary FITS (default: built-in "
                   "3-FWHM dictionary)")
    p.add_argument("--fieldmap", default=None, help="mosaic field map FITS")
    p.add_argument("--psf", default=None, help="explicit PSF cube FITS")
    p.add_argument("--purity", type=float, default=0.9)
    p.add_argument("--purity-std", type=float, default=None)
    p.add_argument("--pfa-areas", type=float, default=0.2)
    p.add_argument("--minsize", type=int, default=100)
    p.add_argument("--pfa-test", type=float, default=0.01)
    p.add_argument("--threshold", type=float, default=None,
                   help="override the purity-calibrated detection threshold")
    p.add_argument("--segmap", default=None,
                   help="user segmentation map FITS for step 07")
    p.add_argument("--grid-dxy", type=int, default=0)
    p.add_argument("--version", default="0.1", help="source file version tag")
    p.add_argument("--n-jobs", type=int, default=1,
                   help="host workers for source-file writing")
    p.add_argument("--no-sources", action="store_true",
                   help="stop after the catalogs (skip masks/source files)")
    p.add_argument("--overlap-ingest", action="store_true",
                   help="survey mode: initialize the next field (its FITS "
                   "read and its copies to the device) before the current "
                   "field's steps run; needs device memory for two fields' "
                   "raw inputs")
    p.add_argument("--mesh", type=int, default=None, metavar="N",
                   help="row-shard the session over the first N GPUs (a "
                   "(1 x N) mesh; Ny must divide by N), or over N CPU "
                   "slots with --device cpu")
    p.add_argument("--precision", choices=("highest", "bf16x3"),
                   default=None,
                   help="matmul precision of the GLR kernels (same as "
                   "ORIGIN_TPU_PRECISION)")
    _add_device_arg(p)


def _steps_from(orig, args, start_at=1):
    """Run steps >= start_at with the CLI's parameters."""
    plan = [
        (1, lambda: orig.step01_preprocessing()),
        (2, lambda: orig.step02_areas(pfa=args.pfa_areas,
                                      minsize=args.minsize)),
        (3, lambda: orig.step03_compute_PCA_threshold(pfa_test=args.pfa_test)),
        (4, lambda: orig.step04_compute_greedy_PCA()),
        (5, lambda: orig.step05_compute_TGLR()),
        (6, lambda: orig.step06_compute_purity_threshold(
            purity=args.purity, purity_std=args.purity_std)),
        (7, lambda: orig.step07_detection(threshold=args.threshold,
                                          segmap=args.segmap)),
        (8, lambda: orig.step08_compute_spectra(grid_dxy=args.grid_dxy)),
        (9, lambda: orig.step09_clean_results()),
    ]
    if not args.no_sources:
        plan += [
            (10, lambda: orig.step10_create_masks()),
            (11, lambda: orig.step11_save_sources(version=args.version,
                                                  n_jobs=args.n_jobs)),
        ]
    for idx, fn in plan:
        if idx >= start_at:
            fn()
    orig.write()
    orig.stat()


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m origin_tpu_torch",
        description="Blind emission-line detection for MUSE datacubes "
        "(ORIGIN pipeline) in PyTorch, on an NVIDIA GPU",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    p_run = sub.add_parser("run", help="run the full pipeline on a cube")
    p_run.add_argument("cube", nargs="+",
                       help="input cube FITS (DATA + STAT); several cubes "
                       "run back to back in one process (survey mode)")
    _add_session_args(p_run)
    _add_run_args(p_run)

    p_res = sub.add_parser("resume", help="resume a saved session")
    p_res.add_argument("folder", help="saved session directory")
    p_res.add_argument("--newname", default=None, help="fork under a new name")
    p_res.add_argument("--loglevel", default="INFO")
    _add_run_args(p_res)

    p_st = sub.add_parser("status", help="session status / timings / stats")
    p_st.add_argument("folder")
    _add_device_arg(p_st)

    p_info = sub.add_parser("info", help="print the session log")
    p_info.add_argument("folder")
    _add_device_arg(p_info)

    args = parser.parse_args(argv)

    from origin_tpu_torch.device import resolve_device
    from origin_tpu_torch.pipeline.session import LOGGER_NAME, ORIGIN
    from origin_tpu_torch.pipeline.steps import Status

    if getattr(args, "precision", None):
        os.environ["ORIGIN_TPU_PRECISION"] = args.precision
    device = resolve_device(args.device)  # a missing GPU fails before I/O
    mesh = None
    if getattr(args, "mesh", None) is not None:
        from origin_tpu_torch.parallel import make_mesh

        # the first N cards, or N slots of the CPU when asked for
        mesh = make_mesh(args.mesh, dp=1, devices=(
            None if device.type == "cuda" else [device] * args.mesh))

    if args.command == "run":
        multi = len(args.cube) > 1
        failures = []
        logger = logging.getLogger(LOGGER_NAME)

        def _init(cube_fn):
            name = args.name
            if multi:
                stem = os.path.splitext(os.path.basename(cube_fn))[0]
                name = f"{args.name}-{stem}"
            return ORIGIN.init(cube_fn, name=name, path=args.path,
                               loglevel=args.loglevel,
                               profiles=args.profiles,
                               fieldmap=args.fieldmap, PSF=args.psf,
                               device=args.device, mesh=mesh)

        # --overlap-ingest: field N+1's session is initialized while field
        # N's is current, before field N's steps run
        pending = []  # [(cube_fn, ORIGIN or None when its init failed)]

        # the sessions share one logger, so a pre-ingested field's file
        # handler would record the current field's steps: it is detached
        # once its init lines are written, and attached again when its own
        # steps start
        def _detach_log(orig):
            if orig.file_handler in orig.logger.handlers:
                orig.logger.removeHandler(orig.file_handler)

        def _attach_log(orig):
            h = orig.file_handler
            if h is not None and h not in orig.logger.handlers:
                orig.logger.addHandler(h)

        def _pop_session(cube_fn):
            if not pending:
                return _init(cube_fn)
            fn, orig = pending.pop(0)
            if orig is None:
                raise RuntimeError(f"initialization failed for {fn}")
            _attach_log(orig)
            return orig

        for i, cube_fn in enumerate(args.cube):
            # survey mode: one bad cube must not abort the remaining
            # fields; no field's logfile handler outlives its run
            orig = None
            try:
                orig = _pop_session(cube_fn)
                if args.overlap_ingest and i + 1 < len(args.cube):
                    nxt_fn = args.cube[i + 1]
                    _detach_log(orig)
                    try:
                        nxt = _init(nxt_fn)
                        _detach_log(nxt)
                        pending.append((nxt_fn, nxt))
                    except Exception:
                        logger.exception("survey: pre-ingest of %s failed",
                                         nxt_fn)
                        pending.append((nxt_fn, None))
                    finally:
                        _attach_log(orig)
                _steps_from(orig, args, start_at=1)
            except Exception:
                if not multi:
                    raise
                failures.append(cube_fn)
                logger.exception(
                    "survey: %s failed; continuing with the next cube",
                    cube_fn,
                )
            finally:
                if orig is not None:
                    orig.close_logfile()
                    # free the finished field's device memory now, for
                    # the next field
                    orig.engine.release()
                    del orig
                    gc.collect()
        if failures:
            print(f"survey: {len(failures)} cube(s) failed: "
                  + " ".join(failures), file=sys.stderr)
            return 1
    elif args.command == "resume":
        orig = ORIGIN.load(args.folder, newname=args.newname,
                           loglevel=args.loglevel, device=args.device,
                           mesh=mesh)
        done = [s.idx for s in orig.steps.values()
                if s.status in (Status.RUN, Status.DUMPED)]
        start = (max(done) + 1) if done else 1
        _steps_from(orig, args, start_at=start)
        orig.close_logfile()
    elif args.command == "status":
        orig = ORIGIN.load(args.folder, loglevel="WARNING",
                           device=args.device)
        orig.status()
        # timestat/stat report via logger.info: raise the console level
        # AFTER the (noisy) load so their records actually print
        orig.set_loglevel("INFO")
        orig.timestat()
        try:
            orig.stat()
        except (KeyError, TypeError):
            # a session stopped before step 09 has no Cat3 to summarize
            pass
        orig.close_logfile()
    elif args.command == "info":
        orig = ORIGIN.load(args.folder, loglevel="WARNING",
                           device=args.device)
        orig.info()
        orig.close_logfile()
    return 0


if __name__ == "__main__":
    sys.exit(main())
