"""What a run of the benchmark must not hold: JAX, its libraries, or the
JAX package the program was ported from. Compared by whole top-level
module names, so the program (`matdeeplearn_torch`) is not taken for the
JAX package (`matdeeplearn_tpu`)."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "matdeeplearn_tpu")


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among `names` (default sys.modules)."""
    tops = {n.split(".", 1)[0] for n in (sys.modules if names is None else names)}
    return sorted(tops & set(FORBIDDEN))
