"""Kernel 1, the float32 GLR spectral sweep (``csrc/toeplitz_sweep.cu``).

One launch sweeps every voxel of the field with every profile of the
dictionary: per voxel and profile, a numerator and a denominator
correlation over the profile's span, one multiply and one add each per
tap.  It reads the filtered cube and the norm cube (float32) and writes
the best statistic, the least (float32) and the best profile's index
(one byte), each once.
"""

import numpy as np

from ..reference import prepared_profiles


def count(config, profiles):
    nvox = int(np.prod(config["shape"]))
    taps = sum(len(p) for p in prepared_profiles(profiles))
    return 2 * 2 * taps * nvox, nvox * (4 + 4 + 4 + 4 + 1), "fp32"
