"""The check that a run loaded neither JAX nor the JAX package.

Names are compared whole, by the part before the first dot: the port,
``ep_tpu_torch``, begins with the JAX package's name ``ep_tpu`` and passes.
"""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ep_tpu"})


def forbidden(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: the
    modules this process has loaded)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
