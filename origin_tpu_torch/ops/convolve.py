"""FFT convolutions of the spatial FSF stage (torch port of
:mod:`origin_tpu.ops.convolve`): the padded FFT shapes, and the batched
'same' 2-D convolution on ``torch.fft`` (cuFFT on a GPU)."""

from __future__ import annotations

import torch

__all__ = ["next_smooth", "fft2_shape", "fftconvolve2d_same"]


def next_smooth(n, factors=(2, 3, 5)):
    """Smallest integer >= n whose prime factors are all in ``factors``."""
    n = int(n)
    while True:
        m = n
        for f in factors:
            while m % f == 0:
                m //= f
        if m == 1:
            return n
        n += 1


def fft2_shape(shape_img, shape_kern):
    """5-smooth padded FFT shape for a linear 2-D convolution."""
    return tuple(
        next_smooth(int(a) + int(b) - 1)
        for a, b in zip(shape_img, shape_kern)
    )


def fftconvolve2d_same(cube, kern, fshape):
    """'same' linear convolution of each channel with its own 2-D kernel.

    ``cube`` is (..., Ny, Nx), ``kern`` (..., Ph, Pw) broadcastable against
    the cube's leading axes, ``fshape`` the padded FFT shape, at least
    (Ny + Ph - 1, Nx + Pw - 1).  Runs on the tensors' device.
    """
    ny, nx = cube.shape[-2:]
    ph, pw = kern.shape[-2:]
    fshape = tuple(int(f) for f in fshape)
    full = torch.fft.irfft2(torch.fft.rfft2(cube, s=fshape)
                            * torch.fft.rfft2(kern, s=fshape), s=fshape)
    y0, x0 = (ph - 1) // 2, (pw - 1) // 2
    return full[..., y0 : y0 + ny, x0 : x0 + nx]
