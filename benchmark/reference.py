"""Plain reference of ORIGIN steps 01 and 04-10.

Written in plain PyTorch and numpy from the published algorithm (Mary et
al. 2020, A&A 635, A194; the ORIGIN reference package), with no kernel,
no batching trick and nothing of the program under test.  The numerical
stages (steps 01, 04, 05, 06, 08) take tensors, compute in ``dtype``
(float64 for the reference, float32 for the control) on their device and
return tensors; matrix products are written as matrix products, so that
the control, run with TF32 on, computes them in TF32.  The catalog stages
(step 07's merging, steps 09 and 10) are integer bookkeeping and
thresholds, in numpy on the host.
"""

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F


@contextlib.contextmanager
def tf32(enabled):
    """Matrix products and convolutions in TF32 (``enabled``) or in full
    float32; the previous setting comes back on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# -- step 01: DCT continuum and standardization --------------------------
def dct_basis(nz, order, dtype, device):
    """Orthonormal DCT-II basis, (nz, order + 1)."""
    z = torch.arange(nz, dtype=torch.float64, device=device)[:, None]
    k = torch.arange(order + 1, dtype=torch.float64, device=device)[None]
    d = math.sqrt(2.0 / nz) * torch.cos(math.pi / nz * (z + 0.5) * k)
    d[:, 0] /= math.sqrt(2.0)
    return d.to(dtype)


def preprocess(raw, var, order=10, dtype=torch.float64, chunk=16384):
    """``(cube_std, mask)`` from the raw cube and variance (NaN where a
    voxel is missing).

    Per spaxel the continuum is the generalized least-squares fit of the
    DCT basis with weights 1/var; a spaxel with a missing voxel gets the
    unweighted fit.  The residual minus each channel's mean over the valid
    voxels, over sqrt(var), is the standardized cube (0 on missing voxels).
    """
    nz, ny, nx = raw.shape
    dev = raw.device
    mask = ~torch.isfinite(raw)
    d = dct_basis(nz, order, dtype, dev)
    k = order + 1
    dd = (d[:, :, None] * d[:, None, :]).reshape(nz, k * k)
    resid = torch.empty((nz, ny * nx), dtype=dtype, device=dev)
    flat_raw = raw.reshape(nz, -1)
    flat_var = var.reshape(nz, -1)
    flat_mask = mask.reshape(nz, -1)
    for s0 in range(0, ny * nx, chunk):
        x = flat_raw[:, s0:s0 + chunk].to(dtype)
        m = flat_mask[:, s0:s0 + chunk]
        x = torch.where(m, 0.0, x)
        w = 1.0 / flat_var[:, s0:s0 + chunk].to(dtype)
        w = torch.where(m.any(dim=0)[None], 1.0, w)
        a = (w.T @ dd).reshape(-1, k, k)
        b = (x * w).T @ d
        coef = torch.linalg.solve(a, b[..., None])[..., 0]
        resid[:, s0:s0 + chunk] = x - d @ coef.T
    resid = resid.reshape(nz, ny, nx)
    good = ~mask
    mean_z = (torch.where(good, resid, 0.0).sum(dim=(1, 2))
              / good.sum(dim=(1, 2)).clamp(min=1))
    out = (resid - mean_z[:, None, None]) / torch.sqrt(var.to(dtype))
    return torch.where(good & torch.isfinite(out), out, 0.0), mask


# -- step 03: the O2 thresholds -------------------------------------------
def o2_threshold(test, pfa, clip=10.0, iters=5):
    """One area's greedy-PCA threshold from its O2 values (numpy, float64),
    the published Gaussian fit: the positive values, clipped at ``clip``
    standard deviations around the median (up to ``iters`` passes), are
    histogrammed (Freedman-Diaconis bins, density); the mode is the left
    edge of the fullest bin and the width is taken from the bin left of it
    nearest half its height; a Gaussian fitted to the bins left of the
    mode plus half the width's FWHM refines both; the threshold is the
    mean plus the ``1 - pfa`` quantile of that Gaussian."""
    from scipy.optimize import curve_fit
    from scipy.stats import norm

    x = np.asarray(test, dtype=float)
    x = x[np.isfinite(x) & (x > 0)]
    for _ in range(iters):
        keep = np.abs(x - np.median(x)) <= clip * np.std(x)
        if keep.all():
            break
        x = x[keep]
    hist, edges = np.histogram(x, bins="fd", density=True)
    top = int(np.argmax(hist))
    mode = edges[top]
    half = (int(np.argmin((hist[top] / 2.0 - hist[:top]) ** 2)) if top
            else 0)
    sigma = (mode - edges[half]) / np.sqrt(2 * np.log(2))
    centers = 0.5 * (edges[1:] + edges[:-1])
    left = centers < mode + 2 * np.sqrt(2 * np.log(2)) * sigma / 2.0
    mean, std = mode, sigma
    if left.sum() >= 3:
        try:
            fit, _ = curve_fit(
                lambda t, a, m, s: a * np.exp(-0.5 * ((t - m) / s) ** 2),
                centers[left], hist[left],
                p0=[hist.max(), mode, abs(sigma) or 1.0], maxfev=10000)
            mean, std = float(fit[1]), float(abs(fit[2]))
        except (RuntimeError, ValueError):
            pass
    return float(mean - std * norm.ppf(pfa))


# -- step 04: greedy PCA -------------------------------------------------
def top_left_vector(xr, steps=200):
    """Unit dominant left singular vector of ``xr`` (nz, m) as the
    system's greedy PCA defines it: ``steps`` power steps of ``xr xr^T``
    from the first column of largest norm, with no stop test.  The steps
    run on the smaller Gram matrix (a matrix product): from column j,
    ``(xr xr^T)^k xr e_j = xr (xr^T xr)^k e_j``."""
    nz, m = xr.shape
    j = torch.argmax(torch.sum(xr * xr, dim=0))
    if m <= nz:
        gram = xr.T @ xr
        v = torch.zeros(m, dtype=xr.dtype, device=xr.device)
        v[j] = 1.0
        for _ in range(steps):
            v = gram @ v
            v = v / torch.linalg.vector_norm(v)
        u = xr @ v
    else:
        gram = xr @ xr.T
        u = xr[:, j]
        for _ in range(steps):
            u = gram @ u
            u = u / torch.linalg.vector_norm(u)
    return u / torch.linalg.vector_norm(u)


def greedy_pca_area(x, test, thres, noise_population=50, itermax=100,
                    vectors=None):
    """One area's greedy PCA (the published loop): ``(faint, mapo2)``.

    ``x`` is the area's (nz, npix) spectra, ``test`` its initial O2 values
    and ``thres`` its threshold.  While some spectrum's O2 exceeds the
    threshold: the mean of the faintest passing spectra is the background
    signature, the nuisance spectra are orthogonalized against it, their
    dominant left singular vector is removed from every spectrum, and O2
    is taken again.  ``vectors``, a list, receives each removed vector.
    """
    npix = x.shape[1]
    mapo2 = torch.zeros(npix, dtype=torch.int32, device=x.device)
    nbiter = 0
    while True:
        nuis = test > thres
        nn = int(nuis.sum())
        if nn == 0:
            break
        nbiter += 1
        mapo2 += nuis.to(torch.int32)
        if nbiter > itermax or nn == 1:
            break
        passing = (test > 0) & (test <= thres)
        nb = 1 + int(int(passing.sum()) / noise_population)
        key = torch.where(passing, test, torch.inf)
        faintest = torch.argsort(key, stable=True)[:nb]
        faintest = faintest[passing[faintest]]
        b = x[:, faintest].mean(dim=1)
        xr = x[:, nuis]
        xr = (xr - torch.outer(b, b @ xr)) / torch.sum(b * b)
        u = top_left_vector(xr)
        if vectors is not None:
            vectors.append(u)
        x = x - torch.outer(u, u @ x)
        test = torch.mean(x * x, dim=0)
    return x, mapo2


def greedy_pca(cube_std, areamap, thresholds, tests, dtype=torch.float64,
               noise_population=50, itermax=100, vectors=None):
    """``(cube_faint, mapO2)`` of every area of ``areamap`` (labels
    1..N), from the standardized cube and step 03's per-area thresholds
    and O2 vectors (row-major order of each area's spaxels).  ``vectors``,
    a dict, receives each area's removed vectors (:func:`greedy_pca_area`).
    """
    nz = cube_std.shape[0]
    flat = cube_std.reshape(nz, -1).to(dtype).clone()
    amap = torch.as_tensor(np.asarray(areamap)).reshape(-1)
    mapo2 = torch.zeros(amap.numel(), dtype=torch.int32)
    for area in range(1, int(amap.max()) + 1):
        idx = torch.nonzero(amap == area)[:, 0]
        if idx.numel() == 0:
            continue
        didx = idx.to(flat.device)
        test = torch.as_tensor(np.asarray(tests[area - 1]),
                               device=flat.device).to(dtype)
        vec = None if vectors is None else vectors.setdefault(area, [])
        faint, m = greedy_pca_area(flat[:, didx], test,
                                   float(thresholds[area - 1]),
                                   noise_population, itermax, vec)
        flat[:, didx] = faint
        mapo2[idx] = m.cpu()
    return flat.reshape(cube_std.shape), mapo2.reshape(np.shape(areamap))


# -- step 05: the GLR matched filter --------------------------------------
def prepared_profiles(profiles, pcut=1e-8, pmeansub=True):
    """Each profile cut to its symmetric support above ``pcut`` around
    its peak, L2-normalized and mean-subtracted (float64 numpy)."""
    out = []
    for prof in profiles:
        p = np.asarray(prof, dtype=np.float64)
        peak = int(p.argmax())
        above = np.nonzero(p >= pcut)[0]
        half = int(np.max(np.abs(above[[0, -1]] - peak)))
        p = p[max(0, peak - half):peak + half + 1]
        p = p / np.linalg.norm(p)
        if pmeansub:
            p = p - p.mean()
        out.append(p)
    return out


def toeplitz_same(p, nz, dtype, device):
    """(nz, nz) matrix T with ``T @ s`` the 'same' convolution of every
    column s with the profile ``p``."""
    n = len(p)
    c = (n - 1) // 2
    i = torch.arange(nz, device=device)
    lag = i[:, None] - i[None, :] + c
    taps = torch.as_tensor(p, dtype=dtype, device=device)
    ok = (lag >= 0) & (lag < n)
    return torch.where(ok, taps[lag.clamp(0, n - 1)], 0.0)


def spatial_filter(cube, psf, dtype, chunk=256, weights=None):
    """``(cube_fsf, norm_fsf)``: each channel correlated with its FSF made
    zero-mean ('same' size, FFT), and the ones image correlated with the
    square of that kernel.

    A mosaic gives ``psf`` as the (F, Nz, P, P) stack of its fields' FSFs
    and ``weights`` as their (F, Ny, Nx) weight maps: each field's term
    is the weighted channel correlated with its own kernel, and the weight
    map with that kernel's square, and the terms are summed (the
    reference's multi-field ``Correlation_GLR_test``)."""
    nz, ny, nx = cube.shape
    p = psf.shape[-1]
    c = (p - 1) // 2
    fy, fx = ny + p - 1, nx + p - 1
    if weights is None:
        psfs, maps = [psf], [None]
    else:
        psfs, maps = list(psf), [w.to(dtype) for w in weights]
    terms = []
    for one, w in zip(psfs, maps):
        kern = torch.flip(one.to(dtype), dims=(1, 2))
        kern = kern - kern.mean(dim=(1, 2), keepdim=True)
        base = (torch.ones((ny, nx), dtype=dtype, device=cube.device)
                if w is None else w)
        terms.append((kern, torch.fft.rfft2(base, s=(fy, fx)), w))
    out = torch.empty((nz, ny, nx), dtype=dtype, device=cube.device)
    norm = torch.empty_like(out)
    for z0 in range(0, nz, chunk):
        for f, (kern, base, w) in enumerate(terms):
            k = kern[z0:z0 + chunk]
            kf = torch.fft.rfft2(k, s=(fy, fx))
            x = cube[z0:z0 + chunk].to(dtype)
            if w is not None:
                x = x * w
            xf = torch.fft.rfft2(x, s=(fy, fx))
            o = torch.fft.irfft2(xf * kf, s=(fy, fx))[:, c:c + ny, c:c + nx]
            nf = torch.fft.rfft2(k * k, s=(fy, fx))
            n = torch.fft.irfft2(base * nf, s=(fy, fx))[:, c:c + ny, c:c + nx]
            if f == 0:
                out[z0:z0 + chunk], norm[z0:z0 + chunk] = o, n
            else:
                out[z0:z0 + chunk] += o
                norm[z0:z0 + chunk] += n
    return out, norm


def glr(cube_faint, mask, psf, profiles, dtype=torch.float64, chunk=16384,
        weights=None):
    """``(correl, correl_min, profile, t_by_profile)``: the best GLR
    statistic over the profiles, the least, the first best profile's index
    and the (K, Nz, Ny, Nx) statistic of every profile.  Missing voxels
    read 0.  A mosaic passes its FSF stack and ``weights``
    (:func:`spatial_filter`)."""
    nz, ny, nx = cube_faint.shape
    dev = cube_faint.device
    cube_fsf, norm_fsf = spatial_filter(cube_faint, psf, dtype,
                                        weights=weights)
    xs, ns = cube_fsf.reshape(nz, -1), norm_fsf.reshape(nz, -1)
    prepped = prepared_profiles(profiles)
    tk = torch.empty((len(prepped), nz, ny * nx), dtype=dtype, device=dev)
    for kidx, p in enumerate(prepped):
        tn = toeplitz_same(p, nz, dtype, dev)
        td = toeplitz_same(p * p, nz, dtype, dev)
        for s0 in range(0, ny * nx, chunk):
            sl = slice(s0, s0 + chunk)
            den = td @ ns[:, sl]
            den = torch.where(den <= 0, torch.inf, den)
            tk[kidx, :, sl] = (tn @ xs[:, sl]) / torch.sqrt(den)
    del cube_fsf, norm_fsf, xs, ns
    tk = tk.reshape(-1, nz, ny, nx).masked_fill(mask[None], 0)
    best, which = tk[0].clone(), torch.zeros(mask.shape, dtype=torch.int64,
                                             device=dev)
    for kidx in range(1, tk.shape[0]):
        up = tk[kidx] > best
        which = torch.where(up, kidx, which)
        best = torch.where(up, tk[kidx], best)
    return best, tk.amin(dim=0), which, tk


# -- step 06: purity thresholds --------------------------------------------
NTHRESH = 50


def purity_threshold(cmax, cmin, purity, l0, l1):
    """The threshold at which ``1 - n_min(t) l1 / (l0 n_max(t))`` reaches
    ``purity`` on a 50-point grid from 1.1 times the median over spaxels
    of the largest local maximum to the least of the two cubes' maxima
    (linear interpolation; infinite when the grid's purity stays below)."""
    peaks = torch.sort(cmax.amax(dim=0).reshape(-1).double()).values
    n = peaks.numel()
    med = float((peaks[(n - 1) // 2] + peaks[n // 2]) * 0.5)
    top = min(float(cmin.max()), float(cmax.max()))
    th = np.linspace(med * 1.1, top, NTHRESH)
    vmax, vmin = cmax.reshape(-1).double(), cmin.reshape(-1).double()
    n1 = np.array([int((vmax > t).sum()) for t in th], float)
    n0 = np.array([int((vmin > t).sum()) for t in th], float) * (l1 / l0)
    with np.errstate(divide="ignore", invalid="ignore"):
        pur = 1.0 - n0 / n1
    if not pur[-1] >= purity:
        return math.inf
    return float(np.interp(purity, pur, th))


def thresholds(lmax, lmin, slmax, slmin, segmap, purity, purity_std):
    """Step 06: the correl threshold (minima counted on the background,
    ``segmap == 0``, scaled to the field) and the std threshold."""
    seg = torch.as_tensor(np.asarray(segmap) == 0, device=lmin.device)
    l1 = float(seg.numel())
    l0 = float(seg.sum())
    t = purity_threshold(lmax, lmin * seg, purity, l0, l1)
    t_std = purity_threshold(slmax, slmin, purity_std, l1, l1)
    return t, t_std


# -- steps 01, 05 and 07: local maxima above a threshold --------------------
def local_maxima(x, mask, size=3):
    """Boolean cube: voxels equal to the maximum of their size^3 box
    (the box cut at the cube's edges), missing voxels excluded."""
    lo = (size - 1) // 2
    pads = [lo, size - 1 - lo] * 3
    xp = F.pad(x[None, None], pads, value=-math.inf)
    box = F.max_pool3d(xp, kernel_size=size, stride=1)[0, 0]
    return (x == box) & ~mask


def local_extrema(x, x_min, mask, size=3):
    """Step 05's (and step 01's) local extrema cubes: the values of ``x``
    at its local maxima and of ``-x_min`` at its, 0 elsewhere."""
    lmax = torch.where(local_maxima(x, mask, size), x, 0)
    lmin = torch.where(local_maxima(-x_min, mask, size), -x_min, 0)
    return lmax, lmin


def detections(x, mask, threshold):
    """Set of (x, y, z) of the local maxima of ``x`` above ``threshold``,
    compared in float32 as the catalog's threshold is applied."""
    keep = local_maxima(x, mask) & (x > torch.tensor(
        threshold, dtype=torch.float32, device=x.device))
    zyx = torch.nonzero(keep).cpu().tolist()
    return {(x_, y_, z_) for z_, y_, x_ in zyx}


# -- step 07: the merged catalog (Cat1) -----------------------------------
def without_duplicates(glr, std, maxdist=2.5):
    """The std-cube detections (rows of (x, y, z)) farther than
    ``maxdist`` from every correl detection, in their order."""
    if len(glr) == 0 or len(std) == 0:
        return std
    d2 = ((std[:, None, :].astype(float) - glr[None, :, :]) ** 2).sum(-1)
    return std[(d2 > maxdist ** 2).all(axis=1)]


def friends_of_friends(x, y, z, tol_spat=3, tol_spec=5):
    """The published spatial pass (``itersrc``): from each unmatched seed
    in row order, the rows closer than ``tol_spat`` to the row visited,
    unmatched when it is visited, join the seed's group one by one in row
    order, each visited in turn before the next joins (depth first); a
    row farther than ``tol_spat * sqrt(2)`` from the seed joins only
    within ``tol_spec`` channels of it.  Returns each row's seed."""
    n = len(x)
    seed_of = np.arange(n)
    matched = np.zeros(n, dtype=bool)

    def near(node):
        return iter(np.nonzero((np.hypot(x[node] - x, y[node] - y)
                                < tol_spat) & ~matched)[0].tolist())

    for seed in range(n):
        if matched[seed]:
            continue
        matched[seed] = True
        stack = [near(seed)]
        while stack:
            cand = next(stack[-1], None)
            if cand is None:
                stack.pop()
                continue
            if matched[cand] or (
                    math.hypot(x[seed] - x[cand], y[seed] - y[cand])
                    > tol_spat * math.sqrt(2)
                    and abs(z[cand] - z[seed]) >= tol_spec):
                continue
            matched[cand] = True
            seed_of[cand] = seed
            stack.append(near(cand))
    return seed_of


def merged_catalog(glr, std, segmap, tol_spat=3, tol_spec=5, maxdist=2.5):
    """Cat1's groups from Cat0's correl and std detections ((x, y, z)
    rows, each in row-major (z, y, x) order, as the detections are
    found): std detections near a correl one dropped, the spatial pass,
    then, within each continuum segment (``segmap`` label > 0 at a
    group's rows, the largest), groups whose lines come within
    ``tol_spec`` channels merged.  Returns ``{(x, y, z, comp): group}``,
    the groups numbered in the order of their seeds."""
    std = without_duplicates(glr, std, maxdist)
    rows = ([tuple(r) + (0,) for r in glr.tolist()]
            + [tuple(r) + (1,) for r in std.tolist()])
    if not rows:
        return {}
    xyz = np.asarray([r[:3] for r in rows], dtype=float)
    seed_of = friends_of_friends(xyz[:, 0], xyz[:, 1], xyz[:, 2], tol_spat,
                                 tol_spec)
    seeds, group = np.unique(seed_of, return_inverse=True)
    seg = np.asarray(segmap)[xyz[:, 1].astype(int), xyz[:, 0].astype(int)]
    area = np.array([seg[group == g].max() for g in range(len(seeds))])
    for a in np.unique(area[area > 0]):
        members = list(np.nonzero(area == a)[0])
        for cu in members:
            live = sorted(set(group[np.isin(group, members)]))
            if len(live) == 1:
                break
            if cu not in live:
                continue
            for other in live:
                if other == cu:
                    continue
                zin = xyz[group == cu, 2]
                zot = xyz[group == other, 2]
                if np.abs(zin[:, None] - zot[None, :]).min() < tol_spec:
                    group[group == other] = cu
    return dict(zip(rows, group.tolist()))


# -- step 08: line estimation ---------------------------------------------
def windows(arr, ys, xs, size, fill):
    """(B, C, size, size) windows of the (C, Ny, Nx) ``arr`` centred at
    (ys, xs); cells outside the field read ``fill``."""
    c, ny, nx = arr.shape
    h = size // 2
    out = torch.full((len(ys), c, size, size), fill, dtype=arr.dtype,
                     device=arr.device)
    for i, (y, x) in enumerate(zip(ys, xs)):
        y0, x0 = int(y) - h, int(x) - h
        ya, yb = max(0, y0), min(ny, y0 + size)
        xa, xb = max(0, x0), min(nx, x0 + size)
        out[i, :, ya - y0:yb - y0, xa - x0:xb - x0] = arr[:, ya:yb, xa:xb]
    return out


def left_vectors(x, steps=200):
    """The unit dominant left singular vector of each (nz, m) matrix of
    the batch ``x`` as the system defines it (:func:`top_left_vector`,
    batched): ``steps`` power steps from the first column of largest
    norm, on the Gram matrix."""
    b, _, m = x.shape
    j = torch.argmax(torch.sum(x * x, dim=1), dim=1)
    gram = x.transpose(1, 2) @ x
    v = torch.zeros((b, m, 1), dtype=x.dtype, device=x.device)
    v[torch.arange(b, device=x.device), j, 0] = 1.0
    for _ in range(steps):
        v = gram @ v
        v = v / torch.linalg.vector_norm(v, dim=1, keepdim=True)
    u = (x @ v)[:, :, 0]
    return u / torch.linalg.vector_norm(u, dim=1, keepdim=True)


def ls_deconv(data, var, psf):
    """The published weighted least-squares point-source amplitude per
    channel, with its weighting (data over sqrt(var), psf^2 over var):
    ``(amplitude, variance)``, each (B, nz)."""
    p, v, d = psf.flatten(-2), var.flatten(-2), data.flatten(-2)
    varest = 1.0 / torch.sum(p * p / v, dim=-1)
    return torch.sum(p * d / torch.sqrt(v), dim=-1) * varest, varest


def deconvolved_lines(raw, var, psf, xs, ys, dtype=torch.float64,
                      order_dct=30, batch=32, weights=None):
    """Step 08's spectrum estimate at each detection (xs, ys), with no
    spatial search (``grid_dxy`` 0).

    Per detection, the minicube the size of the FSF around it (missing
    and outside voxels: data 0, variance infinite) is standardized; its
    dominant component, after the mean spectrum is taken out, is removed;
    the least-squares point source of what is left is subtracted from the
    data; the dominant component of that cleaned cube, smoothed on the
    first ``order_dct`` + 1 DCT vectors, is the continuum; the amplitude
    is the least-squares point source of the standardized data without
    it (the published PCA-LS method).  Returns ``(amplitude, variance)``,
    each (N, nz).

    A mosaic passes ``psf`` as its (F, Nz, P, P) FSF stack and
    ``weights`` as the (F, Ny, Nx) weight maps: each window's FSF is then
    ``sum_f w_f(y, x) psf_f[z, y, x]`` over the window's pixels, the
    weights reading 0 outside the field (the reference's
    ``estimation_line``).
    """
    nz = raw.shape[0]
    size = psf.shape[-1]
    miss = ~torch.isfinite(raw)
    raw0 = torch.where(miss, 0.0, raw)
    var0 = torch.where(miss | ~torch.isfinite(var), math.inf, var)
    psf = psf.to(dtype)
    support = (psf.abs() > 0).to(dtype)
    d0 = dct_basis(nz, order_dct, dtype, raw.device)
    amps, variances = [], []
    for i0 in range(0, len(xs), batch):
        yb, xb = ys[i0:i0 + batch], xs[i0:i0 + batch]
        data = windows(raw0, yb, xb, size, 0.0).to(dtype)
        v = windows(var0, yb, xb, size, math.inf).to(dtype)
        if weights is not None:
            w = windows(weights, yb, xb, size, 0.0).to(dtype)
            psf_b = torch.einsum("bfyx,fzyx->bzyx", w, psf)
            support = (psf_b.abs() > 0).to(dtype)
        else:
            psf_b = psf
        b = data.shape[0]
        sqv = torch.sqrt(v)
        std = data / sqv
        x = std.reshape(b, nz, -1)
        xc = x - x.mean(dim=2, keepdim=True)
        u = left_vectors(xc)
        resid = x - u[:, :, None] * (u[:, None, :] @ xc)
        amp, _ = ls_deconv(resid.reshape(data.shape), v, psf_b)
        clean = ((data - psf_b * amp[..., None, None] * support) / sqv)
        clean = clean.reshape(b, nz, -1)
        u2 = left_vectors(clean - clean.mean(dim=2, keepdim=True))
        u2 = (u2 @ d0) @ d0.T
        resid = std - (u2[:, :, None] * (u2[:, None, :] @ x)).reshape(
            data.shape)
        amp, varest = ls_deconv(resid, v, psf_b)
        amps.append(amp)
        variances.append(varest)
    return torch.cat(amps), torch.cat(variances)


def line_peak(amp, z0, half=5):
    """The published peak search on one detection's amplitude spectrum
    (numpy): the local maximum (strictly above both neighbours) within
    ``half`` channels of ``z0`` nearest the window's centre, or the centre
    if there is none.  Returns ``(z, ok, margin)``: the channel, whether
    the estimate holds (its index in the window is not 0) and the least
    gap between neighbouring amplitudes in the window, on which the choice
    rests."""
    nz = len(amp)
    start, stop = max(0, z0 - half), min(nz, z0 + half + 1)
    v = amp[start:stop]
    n, center = len(v), len(v) // 2
    peaks = [i for i in range(1, n - 1) if v[i] > v[i - 1] and v[i] > v[i + 1]]
    z = min(peaks, key=lambda i: ((i - center) ** 2, i)) if peaks else center
    margin = float(np.abs(np.diff(v)).min()) if n > 1 else math.inf
    return start + z, z != 0, margin


def line_flux(amp, z, half=5):
    """The line's flux: the amplitude summed over ``half`` channels on
    either side of its channel ``z``."""
    return float(amp[max(0, z - half):z + half + 1].sum())


# -- step 09: the cleaned catalog (Cat3) -----------------------------------
def merged_lines(ids, zs, fluxes, nums, z_threshold=5):
    """Within each source, lines sorted by channel form chains where
    neighbours lie under ``z_threshold`` channels apart; every line of a
    chain of two or more is flagged, and all but its brightest (of equal
    fluxes, the last by channel) are merged into it.  Returns
    ``{num_line: (flagged, merged_into or -9999)}``."""
    out = {int(n): (False, -9999) for n in nums}
    for gid in np.unique(ids):
        rows = np.nonzero(ids == gid)[0]
        rows = rows[np.argsort(zs[rows], kind="stable")]
        chain = [rows[0]]
        for r in list(rows[1:]) + [None]:
            if r is not None and zs[r] - zs[chain[-1]] < z_threshold:
                chain.append(r)
                continue
            if len(chain) > 1:
                best = chain[len(chain) - 1
                             - int(np.argmax(fluxes[chain][::-1]))]
                for k in chain:
                    out[int(nums[k])] = (True, -9999 if k == best
                                         else int(nums[best]))
            chain = [r]
    return out


def sources(ids, zs, xs, ys, fluxes, comps, merged_into):
    """Per source: the flux-weighted mean position of its lines (a line
    with no finite flux weighs 0; all weigh 1 where none has one), its
    unmerged lines and the kind of its first line by channel.  Returns
    ``{id: (x, y, n_lines, comp)}``."""
    out = {}
    for gid in np.unique(ids):
        rows = np.nonzero(ids == gid)[0]
        rows = rows[np.argsort(zs[rows], kind="stable")]
        w = np.where(np.isfinite(fluxes[rows]), fluxes[rows], 0.0)
        if not w.any():
            w = np.ones_like(w)
        out[int(gid)] = (float((w * xs[rows]).sum() / w.sum()),
                         float((w * ys[rows]).sum() / w.sum()),
                         int((merged_into[rows] == -9999).sum()),
                         int(comps[rows[0]]))
    return out


# -- step 10: the source and sky masks -------------------------------------
def _labels(on, npixels=5):
    """8-connected segments of the boolean image ``on`` with at least
    ``npixels`` pixels, labelled from 1 (0 elsewhere)."""
    from scipy import ndimage

    lab, n = ndimage.label(on, structure=np.ones((3, 3), int))
    sizes = np.bincount(lab.ravel(), minlength=n + 1)
    keep = np.zeros(n + 1, dtype=int)
    good = [k for k in range(1, n + 1) if sizes[k] >= npixels]
    keep[good] = np.arange(1, len(good) + 1)
    return keep[lab]


def _edge(a):
    return bool(a[0].any() or a[-1].any() or a[:, 0].any() or a[:, -1].any())


def mask_sizes(size=25, steps=5):
    """The published ladder of cutout sizes: odd, times 1.5 a step."""
    out = []
    for _ in range(steps):
        size += 1 - size % 2
        out.append(size)
        size = int(size * 1.5)
    return out


def source_masks(x, y, lines, cube, threshold, sky, fwhm_psf, size=25,
                 min_sky=100):
    """One source's ``(source mask, sky mask)`` (int arrays), the
    published recipe.  ``lines`` are its ``(x0, y0, z0, fwhm)``: detection
    pixel and channel, and its profile's FWHM in channels; ``cube`` the
    (Nz, Ny, Nx) statistic its lines were found in, ``threshold`` the
    segmentation level, ``sky`` the boolean map of continuum-free spaxels,
    ``fwhm_psf`` the FSF's FWHM in pixels per channel.

    For each cutout size of the ladder, centred on the rounded source
    position: each line's image, the maximum over its channels within
    its FWHM, is cut in segments above ``threshold`` (missing and outside
    pixels excluded); the segment under the line, and a disc of radius
    the FSF's FWHM there, join the source mask; the sky mask is the sky
    outside it.  A size is kept when no line falls outside the cutout, the
    mask leaves the cutout's edge free and at least ``min_sky`` sky pixels
    remain; else the next.  The mask is then trimmed as far as these
    hold, no smaller than ``size`` (a trim of one pixel is not made).
    """
    nz, ny, nx = cube.shape
    for step_size in mask_sizes(size):
        h = step_size // 2
        y0, x0 = int(np.rint(y)) - h, int(np.rint(x)) - h
        ya, yb = max(0, y0), min(ny, y0 + step_size)
        xa, xb = max(0, x0), min(nx, x0 + step_size)
        inside = np.zeros((step_size, step_size), dtype=bool)
        inside[ya - y0:yb - y0, xa - x0:xb - x0] = True
        sky_cut = np.zeros((step_size, step_size), dtype=int)
        sky_cut[inside] = np.asarray(sky[ya:yb, xa:xb], int).ravel()
        src = np.zeros((step_size, step_size), dtype=bool)
        yy, xx = np.mgrid[:step_size, :step_size]
        wrong = False
        for lx, ly, lz, lfwhm in lines:
            zlo = max(0, int(lz - lfwhm))
            zhi = min(nz - 1, int(lz + lfwhm))
            img = np.full((step_size, step_size), np.nan)
            img[inside] = np.asarray(
                cube[zlo:zhi + 1, ya:yb, xa:xb].max(axis=0), float).ravel()
            ok = np.isfinite(img)
            seg = _labels(ok & (np.where(ok, img, 0.0) > threshold))
            xi, yi = int(lx) - x0, int(ly) - y0
            if not (0 <= yi < step_size and 0 <= xi < step_size):
                wrong = True
                break
            line = (seg == seg[yi, xi]) if seg[yi, xi] else np.zeros_like(src)
            r = int(math.ceil(fwhm_psf[int(lz)]))
            src |= line | ((xx - xi) ** 2 + (yy - yi) ** 2 <= r * r)
        sky_cut[src] = 0
        wrong |= _edge(src) or int((sky_cut == 1).sum()) < min_sky
        if not wrong:
            break
    border = 1
    while (step_size - 2 * border >= size
           and not _edge(src[border:-border, border:-border])
           and int((sky_cut[border:-border, border:-border] == 1).sum())
           >= min_sky):
        border += 1
    border -= 1
    if border > 1:
        src = src[border:-border, border:-border]
        sky_cut = sky_cut[border:-border, border:-border]
    return src.astype(int), sky_cut
