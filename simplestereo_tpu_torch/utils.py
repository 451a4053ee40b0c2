"""
utils
=====

Host-side helpers, copied from :mod:`simplestereo_tpu.utils` as the port
needs them (numpy only; importing the original would import jax through
its package). So far: :func:`getCrossProductMatrix`, which
:mod:`.rectification` and :mod:`.rigs` use.
"""

import numpy as np


def getCrossProductMatrix(v):
    """3x3 antisymmetric matrix [v]_x representing cross product with ``v``.

    Float64, as in the JAX package (the reference returns float32).
    """
    v = np.asarray(v, np.float64).ravel()
    return np.array(
        [[0, -v[2], v[1]], [v[2], 0, -v[0]], [-v[1], v[0], 0]], dtype=np.float64
    )
