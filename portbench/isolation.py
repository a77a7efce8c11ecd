"""What the benchmark's processes may not hold: JAX, the JAX package
of this repository, or ``msgpack``.  A module is matched by its
top-level name (the part before the first dot) as a whole, so the port,
``dbeel_tpu_torch``, is not mistaken for ``dbeel_tpu``."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "dbeel_tpu", "msgpack"})


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The forbidden modules among ``names`` (``sys.modules`` by
    default), sorted."""
    names = sys.modules if names is None else names
    return sorted(m for m in list(names) if m.split(".")[0] in FORBIDDEN)
