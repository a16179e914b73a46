"""Step 05's spatial stage as DFT-by-matmul, over every field of the
configuration (``origin_tpu_torch.ops.glr.glr_spatial_matmul``, or any
other implementation of the same chain).

Per field and channel the chain is four real DFT stages: the x-DFT of
the (Ny, Nx) image to (Ny, FXr) (two real products), the y-DFT to (FY,
FXr) (four), the product with the field's FSF spectrum (six operations a
frequency), the inverse y-DFT to (Ny, FXr) (four real products) and the
inverse x-DFT to the real (Ny, Nx) image (two).  A multiply-add counts
two operations.  FY x FX is the least padding of a linear correlation,
(Ny + P - 1) x (Nx + P - 1), and FXr = FX // 2 + 1.  The least bytes
read the cube once, each field's FSF spectra (real and imaginary
float32) once and each field's weight map once (a single field has
none), and write the summed result once.  F is the number of ``fields``
of a mosaic configuration, else 1.
"""


def shapes(config):
    """``(F, Nz, Ny, Nx, FY, FXr)`` of the configuration."""
    nz, ny, nx = (int(v) for v in config["shape"])
    p = int(config["psf_size"])
    fy, fx = ny + p - 1, nx + p - 1
    return len(config.get("fields", [None])), nz, ny, nx, fy, fx // 2 + 1


def count(config, profiles):
    nf, nz, ny, nx, fy, fxr = shapes(config)
    per_channel = fxr * (2 * 2 * ny * nx      # x-DFT, two real products
                         + 4 * 2 * fy * ny    # y-DFT, four
                         + 6 * fy             # the spectral product
                         + 4 * 2 * ny * fy    # inverse y-DFT, four
                         + 2 * 2 * ny * nx)   # inverse x-DFT, two
    flops = nf * nz * per_channel
    weights = nf * ny * nx * 4 if "fields" in config else 0
    nbytes = 2 * nz * ny * nx * 4 + nf * nz * fy * fxr * 2 * 4 + weights
    return flops, nbytes, "fp32"
