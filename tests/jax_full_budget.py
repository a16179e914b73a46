"""The JAX greedy PCA with its power iteration run to its whole budget.

``origin_tpu.ops.pca.rank1_left_vector`` stops once ``1 - |<u', u>|``
falls to 1e-7, a test that float32 rounding decides; the torch port runs
the 200-step budget without it (``origin_tpu_torch/ops/pca.py``).  Inside
:func:`jax_full_budget` the JAX package's power iteration is called with
``tol=-1.0``, which never fires, so both packages run the same algorithm
and can be compared exactly.  The JAX package itself is not changed: the
module attribute is swapped for the duration and the jit caches, which
would otherwise hold a trace of either variant, are cleared on entry and
exit.
"""

import contextlib
import functools

import jax

from origin_tpu.ops import pca as jpca


@contextlib.contextmanager
def jax_full_budget():
    plain = jpca.rank1_left_vector
    jpca.rank1_left_vector = functools.partial(plain, tol=-1.0)
    jax.clear_caches()
    try:
        yield
    finally:
        jpca.rank1_left_vector = plain
        jax.clear_caches()
