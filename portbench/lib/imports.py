"""The check that the run never loaded JAX or the JAX package.

Modules are compared by their top-level name (the part before the first
dot) as a whole, so ``fluid_llm_tpu_torch``, the port, is not the JAX
package ``fluid_llm_tpu``.
"""

from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "fluid_llm_tpu"})


def top_level(names) -> set[str]:
    return {n.split(".", 1)[0] for n in names}


def forbidden(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: ``sys.modules``)."""
    return sorted(top_level(sys.modules if names is None else names) & FORBIDDEN)
