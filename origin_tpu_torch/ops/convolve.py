"""Padded FFT shapes for the spatial FSF stage (copy of
:mod:`origin_tpu.ops.convolve`'s host helpers)."""

from __future__ import annotations

__all__ = ["next_smooth", "fft2_shape"]


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
