"""Which forbidden packages a process has loaded.

The program under test is the PyTorch port, ``simplestereo_tpu_torch``;
the JAX package beside it, ``simplestereo_tpu``, and JAX itself must not
run. Names are compared by their top-level part (before the first dot),
as whole strings: ``simplestereo_tpu_torch`` is not ``simplestereo_tpu``.
"""

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "simplestereo_tpu")


def loaded_forbidden(modules=None):
    """Sorted top-level names of ``modules`` (default ``sys.modules``)
    that are in :data:`FORBIDDEN`."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))
