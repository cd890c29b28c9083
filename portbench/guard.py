"""The check that the measured process loaded nothing of JAX or of the JAX
package: top-level module names (the part before the first dot), compared
whole, so that `onepiece_tpu_torch` is not `onepiece_tpu`."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "onepiece_tpu")


def forbidden_modules(modules=None) -> list[str]:
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
