"""The traffic: a synthetic MUSE field made on the device from the seed.

One general generator reads a traffic file's parameters (counts, ranges,
margins): white noise with a channel-dependent level and its variance,
continuum galaxies (a smooth spectrum times a Gaussian blob), emission
lines (a Gaussian in wavelength times the FSF at each channel, scaled to
a peak of 1), and one column of NaN spaxels.  Every seed gives the same
numbers of sources and lines; the seed draws where they lie, how bright
and how wide.  Everything is float32 on the device except the FSF
evaluation (float64, cast once).

A mosaic configuration (``fields``: one FSF model per field, ``fieldmap``:
the rectangle ``[y0, y1, x0, x1]`` each field covers) is seen through the
FSF of the field that covers each pixel: a line's stamp takes, pixel by
pixel, the spot of its field.  The draws and their order are those of a
single field.
"""

import math

import torch


def moffat_cube(lbda, fsf, pixstep, size, dtype=torch.float64):
    """(Nz, size, size) circular Moffat FSF, unit analytic flux, FWHM and
    beta polynomials of the reduced wavelength (MUSE ``FSFMODE 2``)."""
    lb1, lb2 = fsf["lbrange"]
    red = (lbda.to(torch.float64) - lb1) / (lb2 - lb1)

    def polyval(coefs):
        out = torch.zeros_like(red)
        for c in coefs:
            out = out * red + float(c)
        return out

    fwhm = polyval(fsf["fwhm_pol"]) / pixstep
    beta = polyval(fsf["beta_pol"])
    c = (size - 1) / 2.0
    ax = torch.arange(size, dtype=torch.float64, device=lbda.device) - c
    r2 = ax[:, None] ** 2 + ax[None, :] ** 2
    alpha = fwhm / (2.0 * torch.sqrt(2.0 ** (1.0 / beta) - 1.0))
    b, a = beta[:, None, None], alpha[:, None, None]
    out = (b - 1.0) / (math.pi * a ** 2) * (1.0 + r2[None] / a ** 2) ** (-b)
    return out.to(dtype)


def wavelengths(config, device):
    g = config["geometry"]
    nz = config["shape"][0]
    return (float(g["crval_wave"]) + float(g["cdelt_wave"])
            * torch.arange(nz, dtype=torch.float64, device=device))


def fsf_models(config):
    """The FSF model of each field: the configuration's ``fsf``, or one
    per entry of a mosaic's ``fields``, on ``fsf``'s wavelength range."""
    fsf = config["fsf"]
    return ([dict(fsf, **f) for f in config["fields"]]
            if "fields" in config else [fsf])


def field_index(config, device):
    """(Ny, Nx) int64: the field that covers each pixel, 0 everywhere
    without a ``fieldmap``, else from a mosaic's rectangles ``[y0, y1, x0,
    x1]`` (half open); raises unless there is one per FSF model and they
    tile the field without overlap."""
    _, ny, nx = config["shape"]
    if "fieldmap" not in config:
        return torch.zeros((ny, nx), dtype=torch.int64, device=device)
    rects = config["fieldmap"]
    if len(rects) != len(config["fields"]) or len(rects) < 2:
        raise ValueError("a mosaic needs one fieldmap rectangle per field, "
                         "and two fields or more")
    index = torch.full((ny, nx), -1, dtype=torch.int64, device=device)
    for f, (y0, y1, x0, x1) in enumerate(rects):
        if not (0 <= y0 < y1 <= ny and 0 <= x0 < x1 <= nx) or bool(
                (index[y0:y1, x0:x1] >= 0).any()):
            raise ValueError(f"fieldmap rectangle {f} leaves the field or "
                             "overlaps another")
        index[y0:y1, x0:x1] = f
    if bool((index < 0).any()):
        raise ValueError("the fieldmap rectangles leave pixels uncovered")
    return index


def weight_maps(config, device, dtype=torch.float64):
    """(F, Ny, Nx): 1 where field f covers a pixel, else 0."""
    index = field_index(config, device)
    return torch.stack([(index == f).to(dtype)
                        for f in range(len(config["fields"]))])


def _uniform(gen, n, lo_hi, device):
    lo, hi = lo_hi
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=device,
                                       dtype=torch.float64)


def _ints(gen, n, lo, hi, device):
    return torch.randint(lo, hi, (n,), generator=gen, device=device)


def make_field(config, traffic, seed, device):
    """``(data, var, sources)``: float32 (Nz, Ny, Nx) tensors on
    ``device`` and a dict of the drawn source parameters (host lists)."""
    nz, ny, nx = config["shape"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    noise = float(traffic["noise"])
    z = torch.arange(nz, dtype=torch.float64, device=device)
    sigma_z = noise * (1.0 + 0.2 * torch.sin(z / 60.0))
    data = torch.randn((nz, ny, nx), generator=gen, device=device,
                       dtype=torch.float32)
    data *= sigma_z.to(torch.float32)[:, None, None]
    var = (sigma_z ** 2).to(torch.float32)[:, None, None].expand(
        nz, ny, nx).contiguous()

    m = int(traffic["xy_margin"])
    n_cont = int(traffic["n_cont"])
    cx = _ints(gen, n_cont, m, nx - m, device)
    cy = _ints(gen, n_cont, m, ny - m, device)
    camp = _uniform(gen, n_cont, traffic["cont_amp"], device)
    csig = _uniform(gen, n_cont, traffic["cont_sigma"], device)
    yy = torch.arange(ny, dtype=torch.float64, device=device)[:, None]
    xx = torch.arange(nx, dtype=torch.float64, device=device)[None, :]
    blobs = torch.zeros((ny, nx), dtype=torch.float64, device=device)
    for i in range(n_cont):
        blobs += camp[i] * torch.exp(-0.5 * ((yy - cy[i]) ** 2
                                             + (xx - cx[i]) ** 2)
                                     / csig[i] ** 2)
    spectrum = 1.0 + 0.3 * torch.cos(2 * math.pi * z / nz) + 0.2 * z / nz
    data += (spectrum[:, None, None] * blobs[None]).to(torch.float32)

    half, zh = int(traffic["spot_half"]), int(traffic["z_half"])
    zm = int(traffic["z_margin"])
    side = 2 * half + 1
    spots = [moffat_cube(wavelengths(config, device), fsf,
                         float(config["geometry"]["pixstep_arcsec"]), side)
             for fsf in fsf_models(config)]
    spots = torch.stack([s / s.amax(dim=(1, 2), keepdim=True)
                         for s in spots])
    index = field_index(config, device)
    ar = torch.arange(side, device=device)
    lines = []
    for kind in ("faint", "bright"):
        n = int(traffic[f"n_{kind}"])
        lx = _ints(gen, n, m, nx - m, device).tolist()
        ly = _ints(gen, n, m, ny - m, device).tolist()
        lz = _ints(gen, n, zm, nz - zm, device).tolist()
        amp = _uniform(gen, n, traffic[f"{kind}_amp"], device)
        lsig = _uniform(gen, n, traffic["line_sigma"], device)
        for i in range(n):
            z0, y0, x0 = lz[i], ly[i], lx[i]
            z_lo, z_hi = max(0, z0 - zh), min(nz, z0 + zh + 1)
            prof = amp[i] * torch.exp(-0.5 * ((z[z_lo:z_hi] - z0)
                                              / lsig[i]) ** 2)
            # each pixel's spot from the field that covers it
            cut = index[y0 - half:y0 + half + 1, x0 - half:x0 + half + 1]
            spot = spots[cut, z_lo:z_hi, ar[:, None], ar[None, :]
                         ].permute(2, 0, 1)
            data[z_lo:z_hi, y0 - half:y0 + half + 1,
                 x0 - half:x0 + half + 1] += (
                prof[:, None, None] * spot).to(torch.float32)
            lines.append((x0, y0, z0, kind))

    for (y0, x0) in traffic["nan_spaxels"]:
        data[:, y0, x0] = float("nan")
        var[:, y0, x0] = float("nan")
    return data, var, dict(lines=lines, n_cont=n_cont)
