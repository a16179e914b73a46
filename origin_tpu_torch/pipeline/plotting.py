"""Matplotlib diagnostics for ORIGIN sessions.

The port's copy of :mod:`origin_tpu.pipeline.plotting`.  Every view is
drawn on the host from the session's step products; a cube product on the
device reaches it through ``TensorCube.data``, a host copy:

========================  =================================================
view                      derived from
========================  =================================================
``plot_areas``            step02 ``areamap``
``plot_PCA_threshold``    step03 O2 histogram + fitted null + threshold
``plot_step03_*``         step03 per-area threshold grid / outlier scatter
``plot_mapPCA``           step04 ``mapO2`` iteration counts
``plot_purity``           step06 ``Pval`` / ``Pval_comp`` purity scans
``plot_NB``               step07 ``Cat0`` + raw cube narrow bands
``plot_sources``          step05 ``maxmap`` + detection positions
``plot_segmaps``          all segmentation maps present on the session
``plot_min_max_hist``     step05 local-extrema cubes
========================  =================================================

matplotlib is imported inside each method: batch runs never pay for it,
and a machine without it runs every step.
"""

from __future__ import annotations

import numpy as np

__all__ = ["PlotMixin"]


# ---------------------------------------------------------------------------
# small shared helpers


def _canvas(ax):
    """Return ``ax``, or the current axes when none was given."""
    if ax is not None:
        return ax
    import matplotlib.pyplot as plt

    return plt.gca()


def _need(value, step, product):
    """Guard for plots that require an earlier step's product."""
    if value is None:
        raise ValueError(
            f"cannot plot: {product!r} is missing — run {step} first"
        )
    return value


def _fitted_null(edges, counts, mu, sigma):
    """Gaussian null model over histogram bin midpoints, peak-matched.

    Returns ``(mid, model)`` where ``model`` is the N(mu, sigma) density
    rescaled so its maximum coincides with the histogram's tallest bin —
    the visual convention for the O2-test diagnostic.
    """
    mid = 0.5 * (np.asarray(edges[:-1]) + np.asarray(edges[1:]))
    sigma = float(sigma) if sigma else 1.0
    shape = np.exp(-0.5 * ((mid - float(mu)) / sigma) ** 2)
    peak = shape.max()
    if peak > 0 and np.max(counts) > 0:
        shape *= np.max(counts) / peak
    return mid, shape


def _survival_steps(ax, values, label):
    """Draw the count of entries >= t as a step curve (half-pixel bins)."""
    values = np.asarray(values)
    values = values[values > 0]
    if values.size == 0:
        return
    edges = np.arange(0.0, np.ceil(values.max()) + 1.5, 0.5)
    counts, edges = np.histogram(values, bins=edges)
    # survival function: how many extrema sit at or above each threshold
    above = counts[::-1].cumsum()[::-1]
    ax.stairs(above, edges, label=label, linewidth=2)


def _mad_flags(values, cutoff):
    """Boolean mask of entries further than ``cutoff`` MADs from the median."""
    values = np.asarray(values, dtype=float)
    med = np.median(values)
    dev = np.abs(values - med)
    mad = np.median(dev)
    flags = (dev > cutoff * mad) if mad > 0 else np.zeros(len(values), bool)
    return flags, med, mad


def _clipped_window(center, half, size):
    """An inclusive-exclusive slice of width <= 2*half+1 inside [0, size)."""
    return max(0, int(center) - half), min(size, int(center) + half + 1)


class PlotMixin:
    """Diagnostic plots, mixed into the ORIGIN session object."""

    # -- step02 ------------------------------------------------------------

    def plot_areas(self, ax=None, **kwargs):
        """Show the PCA area decomposition as a labelled image."""
        import matplotlib.pyplot as plt

        ax = _canvas(ax)
        labels = np.asarray(
            _need(self.areamap, "step02_areas", "areamap").data
        )
        opts = {"cmap": "jet", "alpha": 0.7, "interpolation": "nearest"}
        opts.update(kwargs)
        opts["origin"] = "lower"
        handle = ax.imshow(labels, **opts)
        if labels.min() != labels.max():
            plt.colorbar(handle, ax=ax)
        return ax

    # -- step03 ------------------------------------------------------------

    def plot_PCA_threshold(self, area, pfa_test="step03", log10=False,
                           legend=True, xlim=None, ax=None):
        """O2-test histogram of one area with its fitted null + threshold.

        With ``pfa_test="step03"`` the stored step03 products are shown;
        passing a float re-evaluates the threshold at that false-alarm
        probability directly from ``cube_std``.
        """
        _need(self.nbAreas, "step02_areas", "nbAreas")
        if pfa_test == "step03":
            saved = self.param.get("compute_PCA_threshold", {}).get("params", {})
            if "pfa_test" not in saved:
                raise ValueError(
                    "no stored pfa_test — run step03_compute_PCA_threshold, "
                    "or pass an explicit pfa_test value"
                )
            pfa = saved["pfa_test"]
            idx = area - 1
            counts, edges = self.histO2[idx], self.binO2[idx]
            cut = float(np.asarray(self.thresO2)[idx])
            mu = float(np.asarray(self.meaO2)[idx])
            sig = float(np.asarray(self.stdO2)[idx])
        else:
            from ..ops.pca import compute_pca_threshold

            pfa = float(pfa_test)
            std = _need(self.cube_std, "step01_preprocessing", "cube_std")
            spaxels = std.data[:, np.asarray(self.areamap.data) == area]
            _, counts, edges, cut, mu, sig = compute_pca_threshold(
                spaxels, pfa
            )

        mid, model = _fitted_null(edges, counts, mu, sig)
        counts = np.asarray(counts, dtype=float)
        if log10:
            with np.errstate(divide="ignore", invalid="ignore"):
                counts, model = np.log10(counts), np.log10(model)

        ax = _canvas(ax)
        ax.plot(mid, counts, "-k")
        ax.plot(mid, counts, ".r")
        ax.plot(mid, model, "-b", alpha=0.5)
        ax.axvline(cut, color="b", lw=2, alpha=0.5)
        ax.grid()
        if xlim is not None:
            ax.set_xlim(xlim)
        ax.set_xlabel("frequency")
        ax.set_ylabel("value")
        if legend:
            ax.text(
                0.1, 0.8,
                f"zone {area}\npfa {pfa:.2f}\nthreshold {cut:.2f}",
                transform=ax.transAxes,
                bbox={"facecolor": "red", "alpha": 0.5},
            )
        return ax

    def plot_step03_PCA_threshold(self, log10=False, ncol=3, legend=True,
                                  xlim=None, fig=None, **fig_kw):
        """Grid of per-area O2 threshold panels (one per PCA area)."""
        import matplotlib.pyplot as plt

        n_areas = _need(self.nbAreas, "step02_areas", "nbAreas")
        if fig is None:
            fig = plt.figure()
        cols = min(n_areas, ncol)
        rows = -(-n_areas // ncol)  # ceil division
        for label in range(1, n_areas + 1):
            panel = fig.add_subplot(max(rows, 1), cols, label, **fig_kw)
            self.plot_PCA_threshold(label, "step03", log10, legend, xlim,
                                    ax=panel)
        fig.subplots_adjust(wspace=0)
        return fig

    def plot_step03_PCA_stat(self, cutoff=5, ax=None):
        """Per-area PCA thresholds with MAD-based outlier flagging."""
        _need(self.nbAreas, "step02_areas", "nbAreas")
        cuts = np.asarray(
            _need(self.thresO2, "step03_compute_PCA_threshold", "thresO2"),
            dtype=float,
        )
        labels = np.arange(1, len(cuts) + 1)
        flags, med, mad = _mad_flags(cuts, cutoff)

        ax = _canvas(ax)
        ax.plot(labels, cuts, "+")
        if flags.any():
            ax.plot(labels[flags], cuts[flags], "ro")
        ax.set_xlabel("area")
        ax.set_ylabel("threshold")
        ax.set_title(f"O2 thresholds: median {med:.2f}, MAD {mad:.2f}, "
                     f"{int(flags.sum())} outlier(s)")
        return ax

    # -- step04 ------------------------------------------------------------

    def plot_mapPCA(self, area=None, iteration=None, ax=None, **kwargs):
        """Per-spaxel greedy-PCA iteration counts, optionally filtered."""
        import matplotlib.pyplot as plt

        counts = np.asarray(
            _need(self.mapO2, "step04_compute_greedy_PCA", "mapO2").data,
            dtype=float,
        )
        hide = np.zeros(counts.shape, dtype=bool)
        caption = "greedy PCA iterations per spaxel"
        if iteration is not None:
            hide |= counts < iteration
            caption += f" (>= {iteration})"
        if area is not None:
            hide |= np.asarray(self.areamap.data) != area
            caption += f" [area {area}]"

        ax = _canvas(ax)
        opts = {"cmap": "jet", "origin": "lower"}
        opts.update(kwargs)
        shown = ax.imshow(np.ma.masked_array(counts, mask=hide), **opts)
        ax.set_title(caption)
        plt.colorbar(shown, ax=ax)
        return ax

    # -- step06 ------------------------------------------------------------

    def plot_purity(self, comp=False, ax=None, log10=False, legend=True):
        """Purity scan: detection counts and purity vs threshold."""
        if comp:
            scan = _need(self.Pval_comp,
                         "step06_compute_purity_threshold", "Pval_comp")
            chosen = self.threshold_std
            target = self.param.get("purity_std")
        else:
            scan = _need(self.Pval,
                         "step06_compute_purity_threshold", "Pval")
            chosen = self.threshold_correl
            target = self.param.get("purity")

        t = np.asarray(scan["Tval_r"], dtype=float)
        ax = _canvas(ax)
        twin = ax.twinx()
        twin.plot(t, np.asarray(scan["Pval_r"]), "y.-", label="purity")
        ax.plot(t, np.asarray(scan["Det_M"]), "b.-",
                label="detections (+DATA)")
        ax.plot(t, np.asarray(scan["Det_m"]), "g.-",
                label="detections (-DATA)")
        if chosen is not None and target is not None:
            twin.plot(chosen, target, "xr")
            ax.axvline(chosen, color="r", alpha=0.25, lw=2,
                       label="selected threshold")
            ax.set_title(f"threshold {chosen:f}")
        if log10:
            ax.set_yscale("log")
            twin.set_yscale("log")
        ax.set_xlabel("threshold")
        ax.set_ylabel("number of detections")
        twin.set_ylabel("purity")
        if legend:
            handles, names = ax.get_legend_handles_labels()
            h2, n2 = twin.get_legend_handles_labels()
            ax.legend(handles + h2, names + n2, loc=2)
        return ax

    # -- step07 ------------------------------------------------------------

    def plot_NB(self, src_ind, ax1=None, ax2=None, ax3=None):
        """Narrow-band triptych around one raw detection.

        Panels: the summed narrow band at the detected wavelength, a
        control band a few line-widths away, and their (scaled) difference
        — a visual sanity check that the detection is not a cube artefact.
        """
        import matplotlib.pyplot as plt

        cat = _need(self.Cat0, "step07_detection", "Cat0")
        if ax1 is None and ax2 is None and ax3 is None:
            _, (ax1, ax2, ax3) = plt.subplots(1, 3, figsize=(12, 4))

        row = {k: cat[k][src_ind] for k in ("x0", "y0", "z0", "profile")}
        px, py, pz = int(row["x0"]), int(row["y0"]), int(row["z0"])
        nz, ny, nx = self.shape

        # spatial window: fixed 41-pixel box clipped to the field
        ylo, yhi = _clipped_window(py, 20, ny)
        xlo, xhi = _clipped_window(px, 20, nx)
        # spectral window: the detected profile's support
        prof = self.profiles[int(row["profile"])]
        half = int((prof > 1e-13).sum()) // 2
        zlo, zhi = _clipped_window(pz, half, nz)
        width = 2 * half + 1

        # control band: 3 line-widths redward, or blueward near the red end
        shift = 3 * width if pz + half + 3 * width < nz else -3 * width
        band = self.cube_raw[zlo:zhi, ylo:yhi, xlo:xhi]
        control = self.cube_raw[zlo + shift:zhi + shift, ylo:yhi, xlo:xhi]
        residual = (band - control) / np.sqrt(2.0)

        panels = [
            (ax1, band, f"narrow band ({px},{py})"),
            (ax2, control, "control band"),
            (ax3, residual, "difference"),
        ]
        for panel, cube, caption in panels:
            if panel is None:
                continue
            shown = panel.imshow(cube.sum(axis=0), origin="lower")
            panel.plot(px - xlo, py - ylo, "m+")
            panel.set_title(caption)
            plt.colorbar(shown, ax=panel)
        return ax1, ax2, ax3

    def plot_sources(self, x, y, circle=False, vmin=0, vmax=30, title=None,
                     ax=None, **kwargs):
        """Detection positions drawn over the GLR max-map."""
        import matplotlib.pyplot as plt

        ax = _canvas(ax)
        kwargs.setdefault("origin", "lower")
        ax.imshow(
            _need(self.maxmap, "step05_compute_TGLR", "maxmap").data,
            vmin=vmin, vmax=vmax, **kwargs,
        )
        if title:
            ax.set_title(title)
        if circle:
            fwhm = self.FWHM_PSF
            if self.wfields is not None:  # mosaic: widest field wins
                fwhm = np.max(np.asarray(fwhm))
            r = round(float(fwhm) / 2)
            for cx, cy in zip(x, y):
                ax.add_artist(plt.Circle((cx, cy), r, color="k", fill=False))
        else:
            ax.plot(x, y, "k+")
        return ax

    # -- cross-step --------------------------------------------------------

    def plot_segmaps(self, axes=None, figsize=(6, 6)):
        """All segmentation maps the session has produced, side by side."""
        import matplotlib.pyplot as plt

        available = [
            (name, getattr(self, name, None))
            for name in ("segmap_cont", "segmap_merged", "segmap_purity",
                         "segmap_label")
        ]
        available = [(n, im) for n, im in available if im is not None]
        if not available:
            self.logger.warning("no segmentation map to plot yet")
            return
        if axes is None:
            _, axes = plt.subplots(
                1, len(available), sharex=True, sharey=True,
                figsize=(figsize[0] * len(available), figsize[1]),
            )
        axes = np.atleast_1d(axes)
        for panel, (name, im) in zip(axes, available):
            panel.imshow(im.data, cmap="nipy_spectral", origin="lower",
                         interpolation="nearest")
            panel.set_title(name)
        return axes

    def plot_min_max_hist(self, ax=None, comp=False):
        """Survival histograms of the local-extrema values (step05).

        Shows, for each threshold t, how many local maxima / minima sit at
        or above t — the raw material of the step06 purity scan.  With
        ``comp=True`` the std-cube extrema are shown instead of the GLR ones.
        """
        import matplotlib.pyplot as plt

        if comp:
            peaks = _need(self.cube_std_local_max, "step01_preprocessing",
                          "cube_std_local_max").data
            dips = self.cube_std_local_min.data
        else:
            peaks = _need(self.cube_local_max, "step05_compute_TGLR",
                          "cube_local_max").data
            dips = self.cube_local_min.data

        if ax is None:
            _, ax = plt.subplots(1, 1, figsize=(12, 6))
        ax.set_yscale("log")
        ax.grid(which="major", linewidth=1)
        ax.grid(which="minor", linewidth=1, linestyle=":")
        _survival_steps(ax, peaks, "max")
        _survival_steps(ax, dips, "min")
        if self.segmap_purity is not None:
            background = np.asarray(self.segmap_purity.data) == 0
            _survival_steps(ax, np.asarray(dips)[:, background], "min (bg)")
        ax.legend()
        ax.set_title("local extrema above threshold")
        return ax
