"""
geometry
========

Projective-geometry primitives on tensors, the port of
:mod:`simplestereo_tpu.geometry`: Rodrigues conversions, the
Brown-Conrady distortion model and projection. :mod:`.npgeom` is the
numpy float64 copy for host-side rig algebra.
"""

from .rotations import rodrigues_to_matrix, matrix_to_rodrigues
from .distortion import distort_normalized, undistort_normalized, undistort_points, distort_points
from .projection import (
    project_points,
    perspective_transform,
    to_homogeneous,
    from_homogeneous,
    cross_product_matrix,
)

__all__ = [
    "rodrigues_to_matrix",
    "matrix_to_rodrigues",
    "distort_normalized",
    "undistort_normalized",
    "undistort_points",
    "distort_points",
    "project_points",
    "perspective_transform",
    "to_homogeneous",
    "from_homogeneous",
    "cross_product_matrix",
]
