"""Small shared utilities.

(The port's copy of ``progressbar`` from ``origin_tpu/utils.py``, without
tqdm: the port depends on nothing that the card's machine may lack.)
"""

from __future__ import annotations

__all__ = ["progressbar"]


def progressbar(iterable=None, **kwargs):
    """The iterable itself: a progress bar that draws nothing.

    Takes tqdm's keywords (``total``, ``desc``, ``leave``) so call sites
    read as in the JAX package; with no iterable it returns None, as the
    JAX package's does without tqdm.
    """
    return iterable
