"""The run loads no JAX and nothing of the JAX package: each loaded
module's top-level name (before the first dot) is compared whole, since
the program's own package name begins with the JAX package's."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "tailored_avsr_tpu"})


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
