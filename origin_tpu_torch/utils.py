"""Small shared utilities.

(The port's copies of ``timeit`` and ``progressbar`` from
``origin_tpu/utils.py``, the latter without tqdm: the port depends on
nothing that the card's machine may lack.)
"""

from __future__ import annotations

import logging
from functools import wraps
from time import time

__all__ = ["timeit", "progressbar"]


def timeit(f):
    """Debug-log the wall time of each call of ``f`` on its module's
    logger."""

    @wraps(f)
    def timed(*args, **kw):
        logger = logging.getLogger(f.__module__)
        t0 = time()
        result = f(*args, **kw)
        logger.debug("%s executed in %0.1fs", f.__name__, time() - t0)
        return result

    return timed


def progressbar(iterable=None, **kwargs):
    """The iterable itself: a progress bar that draws nothing.

    Takes tqdm's keywords (``total``, ``desc``, ``leave``) so call sites
    read as in the JAX package; with no iterable it returns None, as the
    JAX package's does without tqdm.
    """
    return iterable
