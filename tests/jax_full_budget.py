"""The JAX power iterations run to their whole budget.

``origin_tpu.ops.pca.rank1_left_vector`` stops once ``1 - |<u', u>|``
falls to 1e-7, a test that float32 rounding decides; the torch port runs
the 200-step budget without it (``origin_tpu_torch/ops/pca.py``).  Inside
:func:`jax_full_budget` the JAX package's power iteration is called with
``tol=-1.0``, which never fires, so both packages run the same algorithm
and can be compared exactly: in the greedy PCA of step 04 and in the two
rank-1 PCAs of step 08's line estimation (``origin_tpu.ops.lines`` bound
its own copy of the name at import, so it is swapped too).  The JAX
package itself is not changed: the module attributes are swapped for the
duration and the jit caches, which would otherwise hold a trace of either
variant, are cleared on entry and exit.
"""

import contextlib
import functools

import jax

from origin_tpu.ops import lines as jlines
from origin_tpu.ops import pca as jpca


@contextlib.contextmanager
def jax_full_budget():
    plain = jpca.rank1_left_vector
    full = functools.partial(plain, tol=-1.0)
    jpca.rank1_left_vector = jlines.rank1_left_vector = full
    jax.clear_caches()
    try:
        yield
    finally:
        jpca.rank1_left_vector = jlines.rank1_left_vector = plain
        jax.clear_caches()
