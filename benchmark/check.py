"""The comparison that decides ``correct``.

The plain reference (``reference.py``) follows the survey stage by stage:
step 01 from the raw field the benchmark made, and each later stage from
the program's own product of the stage before it (step 03's thresholds
from its O2 values; step 04 from its standardized cube, areas and O2
thresholds; step 05 from its faint cube; step 06 from the local extrema
of the reference's own statistic and standardized cube; step 07 from the
program's statistic cubes, thresholds and continuum segments (step 02's
areas and step 07's deblended segments are taken as the program made
them and not held); step 08 from the raw field at the
program's Cat1 positions; step 09 from the program's Cat2; step 10 from
the program's Cat3, cubes, thresholds and segments).  Each number measures
how far what the program produced lies from what the float64 reference
computes from the same inputs (a widest gap, or a count of rows, lines or
pixels that differ); the limits are in the configuration's file.  The
control is the same reference in float32 with TF32 matrix products, put
in the program's place in the numerical stages.  Each stage is compared
on the device as soon as it is computed, and freed.  A mosaic's steps 05
and 08 are held to the reference's sums over its fields' FSFs, weighted
by maps made from the configuration's rectangles, not the program's.
"""

import math
import os

import numpy as np
import torch

from . import fitsfile
from . import reference as ref

CUBES = ("cube_std", "cube_faint", "cube_correl", "cube_correl_min",
         "cube_profile", "cube_local_max", "cube_local_min",
         "cube_std_local_max", "cube_std_local_min")
# a line's peak choice rests on neighbouring amplitudes at least this far
# apart, in units of the amplitude's standard deviation, or is not held
DECIDED = 1e-3


def _col(table, name, dtype=None):
    return np.asarray(table[name], dtype=dtype)


def _read_mask(path):
    if not os.path.exists(path):
        return None
    return next(d for _, d in fitsfile.read_images(path) if d is not None)


def products(orig):
    """The products that the comparison reads, copied to the host from a
    finished session (``engine.get`` uploads an offloaded one first)."""
    eng = orig.engine
    out = {n: eng.get(n).cpu() for n in CUBES}
    faint = eng._peek("cube_faint")
    recipe = getattr(faint, "recipe", None)
    payload = getattr(recipe, "payload", None) or getattr(faint, "payload",
                                                           None) or []
    amap = np.asarray(orig.areamap.data).reshape(-1)
    # step 04's removed vectors, first iteration first, by area label
    out["pca_vectors"] = {int(amap[idx[0]]): torch.as_tensor(np.asarray(u))
                          for idx, u, _ in payload}
    cat0 = orig.Cat0
    comp = _col(cat0, "comp")
    rows = np.stack([_col(cat0, c, int) for c in ("x0", "y0", "z0")], 1)
    cat1 = orig.Cat1
    cat2, lines, srcs = orig.Cat2, orig.Cat3_lines, orig.Cat3_sources
    tpl = orig.param["mask_filename_tpl"]
    sky_tpl = orig.param["skymask_filename_tpl"]
    out.update(
        areamap=np.asarray(orig.areamap.data),
        thresO2=[float(t) for t in orig.thresO2],
        testO2=[np.asarray(t, np.float64) for t in orig.testO2],
        segmap_purity=np.asarray(orig.segmap_purity.data),
        segmap_label=np.asarray(orig.segmap_label.data),
        threshold=float(orig.param["threshold"]),
        threshold_std=float(orig.param["threshold_std"]),
        cat0_glr=set(map(tuple, rows[comp == 0].tolist())),
        cat0_std=set(map(tuple, rows[comp == 1].tolist())),
        cat1={(int(x), int(y), int(z), int(c)): int(i) for x, y, z, c, i in
              zip(*(_col(cat1, k) for k in ("x0", "y0", "z0", "comp",
                                            "ID")))},
        cat2={k: _col(cat2, k) for k in ("num_line", "ID", "x0", "y0", "z0",
                                         "x", "y", "z", "flux", "comp",
                                         "profile")},
        spectra={int(n): np.asarray(getattr(sp.data, "filled", lambda v:
                                            sp.data)(np.nan), np.float64)
                 for n, sp in orig.spectra.items()},
        cat3_lines={k: _col(lines, k) for k in (
            "num_line", "ID", "x0", "y0", "z0", "z", "profile", "merged_in",
            "line_merged_flag")},
        cat3_sources={int(i): (float(x), float(y), int(n), int(c))
                      for i, x, y, n, c in zip(*(_col(srcs, k) for k in (
                          "ID", "x", "y", "n_lines", "comp")))},
        masks={int(i): (_read_mask(tpl % int(i)), _read_mask(sky_tpl % int(i)))
               for i in _col(srcs, "ID")},
    )
    return out


def _gap(a, b):
    return float((a.to(b.device).double() - b.double()).abs().max())


def area_gaps(got, want, areamap):
    """The widest gap between two (Nz, Ny, Nx) cubes in each area of
    ``areamap`` (labels 1..N), as a list."""
    amap = torch.as_tensor(np.asarray(areamap)).reshape(-1).to(want.device)
    diff = (got.to(want.device).double() - want.double()).abs()
    col = diff.reshape(diff.shape[0], -1).amax(dim=0)
    return [float(col[amap == a].max()) for a in range(1, int(amap.max()) + 1)
            if bool((amap == a).any())]


def first_vector_gap(got, want):
    """The widest gap, over the areas, between the first vector that
    step 04 removes there and the reference's (sign aligned); 1 where one
    side removes none."""
    worst = 0.0
    for area in set(got) | set(want):
        if area not in got or area not in want:
            return 1.0
        g = got[area][:, 0].to(want[area].device).double()
        w = want[area][:, 0].double()
        g = g * torch.sign(torch.dot(g, w))
        worst = max(worst, float((g - w).abs().max()))
    return worst


def median(values):
    v = sorted(values)
    n = len(v)
    return 0.5 * (v[(n - 1) // 2] + v[n // 2])


def spectrum_range(z, radius, nz):
    """The channels that step 08 keeps of a line's spectrum: ``radius``
    on either side of its channel, inside the cube."""
    return max(0, z - radius), min(nz - 1, z + radius)


def estimated_lines(amp, x0, y0, z0, profile, radius):
    """What step 08 reports, worked out from amplitude spectra ``amp``
    (N, nz) (numpy): each line's position, channel, flux and kept
    spectrum, as the program's products give them (``products``)."""
    nz = amp.shape[1]
    cat2 = dict(num_line=np.arange(1, len(z0) + 1), x=np.array(x0),
                y=np.array(y0), z=np.zeros(len(z0), int),
                flux=np.zeros(len(z0)))
    spectra = {}
    for i in range(len(z0)):
        z, ok, _ = ref.line_peak(amp[i], int(z0[i]))
        cat2["z"][i] = z if ok else z0[i]
        cat2["flux"][i] = ref.line_flux(amp[i], z) if ok else 0.0
        if ok:
            lo, hi = spectrum_range(z, radius[int(profile[i])], nz)
            spectra[i + 1] = amp[i, lo:hi + 1]
    return cat2, spectra


def line_numbers(cat2, spectra, amp, varest, x0, y0, z0, profile, radius):
    """Step 08's numbers for reported lines (``cat2``, ``spectra`` by
    line number) against the float64 amplitudes and variances (numpy):
    ``line_pos_differ``, the lines whose position or channel is not the
    reference's (a channel whose choice rests on amplitudes closer than
    ``DECIDED`` standard deviations is not held), or that the reference
    keeps and the run does not or the reverse; ``flux_gap``, the widest
    gap of a line's flux from the reference's over the same channels, in
    standard deviations of that flux; ``line_gap``, the widest gap of a
    kept spectrum from the reference's, in standard deviations."""
    nz = amp.shape[1]
    differ, flux_gap, line_gap = 0, 0.0, 0.0
    for i in range(len(z0)):
        z_ref, ok, margin = ref.line_peak(amp[i], int(z0[i]))
        num = int(cat2["num_line"][i])
        z = int(cat2["z"][i])
        lo5, hi5 = max(0, z - 5), min(nz, z + 6)
        scale = math.sqrt(float(varest[i, lo5:hi5].min()))
        decided = margin > DECIDED * scale
        if (int(cat2["x"][i]) != int(x0[i]) or int(cat2["y"][i]) != int(y0[i])
                or (num in spectra) != ok or (decided and z != z_ref)):
            differ += 1
        if num not in spectra:
            continue
        want = ref.line_flux(amp[i], z)
        sd = math.sqrt(float(varest[i, lo5:hi5].sum()))
        flux_gap = max(flux_gap, abs(float(cat2["flux"][i]) - want) / sd)
        lo, hi = spectrum_range(z, radius[int(profile[i])], nz)
        got = np.asarray(spectra[num], np.float64)
        if len(got) != hi - lo + 1:
            differ += 1
            continue
        line_gap = max(line_gap, float(np.max(
            np.abs(got - amp[i, lo:hi + 1])
            / np.sqrt(varest[i, lo:hi + 1]))))
    return dict(line_pos_differ=differ, flux_gap=flux_gap, line_gap=line_gap)


def cat1_differ(got, want):
    """Rows of Cat1 in one catalog only, and rows whose group (the set
    of rows sharing its ID) differs."""
    def groups(cat):
        by = {}
        for row, g in cat.items():
            by.setdefault(g, set()).add(row)
        return {row: frozenset(by[g]) for row, g in cat.items()}

    g, w = groups(got), groups(want)
    return (len(set(g) ^ set(w))
            + sum(g[r] != w[r] for r in set(g) & set(w)))


def cat3_differ(cat2, lines, sources_got):
    """Step 09 from the program's Cat2: Cat3 lines whose merge flag or
    target differs, and sources whose number of lines or kind differs or
    whose position lies more than 1e-6 pixel from the reference's."""
    merged = ref.merged_lines(cat2["ID"], cat2["z"], cat2["flux"],
                              cat2["num_line"])
    got = {int(n): (bool(f), int(m)) for n, f, m in zip(
        lines["num_line"], lines["line_merged_flag"], lines["merged_in"])}
    differ = len(set(got) ^ set(merged)) + sum(
        got[n] != merged[n] for n in set(got) & set(merged))
    into = np.array([merged[int(n)][1] for n in cat2["num_line"]])
    want = ref.sources(cat2["ID"], cat2["z"], cat2["x"].astype(float),
                       cat2["y"].astype(float), cat2["flux"].astype(float),
                       cat2["comp"], into)
    differ += len(set(want) ^ set(sources_got))
    for i in set(want) & set(sources_got):
        (xg, yg, ng, cg), (xw, yw, nw, cw) = sources_got[i], want[i]
        differ += (ng != nw or cg != cw or abs(xg - xw) > 1e-6
                   or abs(yg - yw) > 1e-6)
    return differ


def masks_differ(prog, fwhm_profiles, fwhm_psf, factor=0.5):
    """Step 10 from the program's Cat3, cubes, thresholds and segments:
    the pixels of the source and sky masks that differ from the
    reference's (a mask of another size, or missing, counts whole)."""
    lines = prog["cat3_lines"]
    cubes = {0: prog["cube_correl"].numpy(), 1: prog["cube_std"].numpy()}
    thr = {0: prog["threshold"] * factor, 1: prog["threshold_std"] * factor}
    sky = prog["segmap_label"] == 0
    differ = 0
    for sid, (x, y, _, comp) in prog["cat3_sources"].items():
        rows = np.nonzero(lines["ID"] == sid)[0]
        rows = rows[np.argsort(lines["z"][rows], kind="stable")]
        own = [(int(lines["x0"][r]), int(lines["y0"][r]),
                int(lines["z0"][r]),
                fwhm_profiles[int(lines["profile"][r])]) for r in rows]
        want = ref.source_masks(x, y, own, cubes[comp], thr[comp], sky,
                                fwhm_psf)
        for got, w in zip(prog["masks"].get(sid, (None, None)), want):
            if got is None or got.shape != w.shape:
                differ += w.size
            else:
                differ += int((got != w).sum())
    return differ


def verdict(numbers, limits):
    """``(checks, correct)``: each number that has a limit, beside it,
    and whether every one is within its limit."""
    checks = {k: dict(value=numbers[k], limit=v) for k, v in limits.items()
              if k in numbers}
    return checks, all(c["value"] <= c["limit"] for c in checks.values())


def readings(prog, inputs, device, control=False):
    """``(program, control)``: the numbers compared for the program's
    products ``prog`` and, with ``control``, for the control (else
    None).  ``inputs`` holds what the reference takes besides them
    (``run.reference_inputs``)."""
    dev = torch.device(device)
    raw, var, psf = (inputs[k].to(dev) for k in ("raw", "var", "psf"))
    weights = inputs.get("weights")
    if weights is not None:
        weights = weights.to(dev)
    mask = ~torch.isfinite(raw)
    keep = ~mask
    p, c = {}, {} if control else None

    def stage(fn):
        with ref.tf32(False):
            want = fn(torch.float64)
        if not control:
            return want, None
        with ref.tf32(True):
            return want, fn(torch.float32)

    def put(name, value_of, want, ctl, got):
        p[name] = value_of(got, want)
        if control:
            c[name] = value_of(ctl, want)

    # step 01, from the raw field
    want, ctl = stage(lambda dt: ref.preprocess(raw, var, dtype=dt)[0])
    put("std_gap", _gap, want, ctl, prog["cube_std"])
    std_want, std_ctl = want, ctl

    # step 03's thresholds, from the program's O2 values
    p["o2_threshold_differ"] = sum(
        abs(t - ref.o2_threshold(o2, inputs["pfa_test"])) > 1e-9 * abs(t)
        for t, o2 in zip(prog["thresO2"], prog["testO2"]))

    # step 04, from the program's cube_std, areas and O2 thresholds
    std = prog["cube_std"].to(dev)

    def greedy(dt):
        vectors = {}
        faint, mapo2 = ref.greedy_pca(std, prog["areamap"], prog["thresO2"],
                                      prog["testO2"], dt, vectors=vectors)
        return faint, mapo2, {a: torch.stack(v, 1) for a, v in
                              vectors.items() if v}

    want, ctl = stage(greedy)
    del std
    got = (prog["cube_faint"], None, prog["pca_vectors"])
    put("faint_gap_median_area", lambda g, w: median(
        area_gaps(g[0], w[0], prog["areamap"])), want, ctl, got)
    put("pca_first_u_gap", lambda g, w: first_vector_gap(g[2], w[2]),
        want, ctl, got)
    del want, ctl

    # step 05, from the program's cube_faint
    faint = prog["cube_faint"].to(dev)
    want, ctl = stage(lambda dt: ref.glr(faint, mask, psf, inputs["profiles"],
                                         dt, weights=weights))
    del faint

    def correl_gap(g, w):
        return max(_gap(g[0], w[0]), _gap(g[1], w[1]))

    def profile_gap(g, w):
        t_at = torch.gather(w[3], 0, g[2].to(dev).long()[None])[0]
        return float((w[0] - t_at)[keep].max())

    got = (prog["cube_correl"], prog["cube_correl_min"],
           prog["cube_profile"])
    put("correl_gap", correl_gap, want, ctl, got)
    put("profile_gap", profile_gap, want, ctl, got)

    # step 06, from the local extrema of step 05's statistic and step 01's
    # cube (the reference's own, from the stages above) and the program's
    # background map
    def thresholds(glr_out, cube_std):
        lmax, lmin = ref.local_extrema(glr_out[0], glr_out[1], mask)
        slmax, slmin = ref.local_extrema(cube_std, cube_std, mask)
        return ref.thresholds(lmax, lmin, slmax, slmin,
                              prog["segmap_purity"], inputs["purity"],
                              inputs["purity"])

    thr_want = thresholds(want, std_want)
    del want, std_want
    thr_ctl = None if ctl is None else thresholds(ctl, std_ctl)
    del ctl, std_ctl
    put("threshold_gap", lambda g, w: max(abs(g[0] - w[0]), abs(g[1] - w[1])),
        thr_want, thr_ctl, (prog["threshold"], prog["threshold_std"]))

    # step 07, from the program's cubes, thresholds and continuum segments
    found = (ref.detections(prog["cube_correl"].to(dev), mask,
                            prog["threshold"]),
             ref.detections(prog["cube_std"].to(dev), mask,
                            prog["threshold_std"]))
    p["cat0_differ"] = (len(prog["cat0_glr"] ^ found[0])
                        + len(prog["cat0_std"] ^ found[1]))

    def row_major(rows):
        return np.array(sorted(rows, key=lambda r: (r[2], r[1], r[0])),
                        dtype=int).reshape(-1, 3)

    p["cat1_differ"] = cat1_differ(prog["cat1"], ref.merged_catalog(
        row_major(found[0]), row_major(found[1]), prog["segmap_label"]))

    # step 08, from the raw field at the program's Cat1 positions
    cat2 = prog["cat2"]
    pos = (cat2["x0"], cat2["y0"], cat2["z0"], cat2["profile"],
           inputs["spectrum_radius"])
    want, ctl = stage(lambda dt: ref.deconvolved_lines(
        raw, var, psf, cat2["x0"], cat2["y0"], dt, weights=weights))
    del raw, var
    want = tuple(t.cpu().double().numpy() for t in want)
    p.update(line_numbers(cat2, prog["spectra"], *want, *pos))
    if control:
        ctl_amp = ctl[0].cpu().double().numpy()
        c.update(line_numbers(*estimated_lines(ctl_amp, *pos), *want, *pos))
    del ctl

    # steps 09 and 10, from the program's Cat2, then its Cat3
    p["cat3_differ"] = cat3_differ(cat2, prog["cat3_lines"],
                                   prog["cat3_sources"])
    p["masks_differ"] = masks_differ(prog, inputs["fwhm_profiles"],
                                     inputs["fwhm_psf"])
    return p, c
