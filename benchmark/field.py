"""The traffic: a synthetic MUSE field made on the device from the seed.

One general generator reads a traffic file's parameters (counts, ranges,
margins): white noise with a channel-dependent level and its variance,
continuum galaxies (a smooth spectrum times a Gaussian blob), emission
lines (a Gaussian in wavelength times the FSF at each channel, scaled to
a peak of 1), and one column of NaN spaxels.  Every seed gives the same
numbers of sources and lines; the seed draws where they lie, how bright
and how wide.  Everything is float32 on the device except the FSF
evaluation (float64, cast once).
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
    spot = moffat_cube(wavelengths(config, device), config["fsf"],
                       float(config["geometry"]["pixstep_arcsec"]), side)
    spot = spot / spot.amax(dim=(1, 2), keepdim=True)
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
            data[z_lo:z_hi, y0 - half:y0 + half + 1,
                 x0 - half:x0 + half + 1] += (
                prof[:, None, None] * spot[z_lo:z_hi]).to(torch.float32)
            lines.append((x0, y0, z0, kind))

    for (y0, x0) in traffic["nan_spaxels"]:
        data[:, y0, x0] = float("nan")
        var[:, y0, x0] = float("nan")
    return data, var, dict(lines=lines, n_cont=n_cont)
