"""
projection
==========

Camera projection and homography application on tensors: the port of
:mod:`simplestereo_tpu.geometry.projection`. Products are written out as
sums (:mod:`._small`).
"""

import torch

from ._small import apply_affine
from .rotations import _skew, rodrigues_to_matrix
from .distortion import distort_normalized


def to_homogeneous(points):
    """Append a 1 to the last axis: (..., n) -> (..., n+1)."""
    points = torch.as_tensor(points)
    ones = torch.ones(points.shape[:-1] + (1,), dtype=points.dtype,
                      device=points.device)
    return torch.cat([points, ones], dim=-1)


def from_homogeneous(points):
    """Divide by the last coordinate: (..., n+1) -> (..., n)."""
    points = torch.as_tensor(points)
    return points[..., :-1] / points[..., -1:]


def cross_product_matrix(v):
    """3x3 antisymmetric matrix [v]_x such that [v]_x @ w == v x w."""
    return _skew(torch.as_tensor(v).reshape(3))


def perspective_transform(points, M):
    """Apply a projective transform to 2D or 3D points.

    Drop-in for ``cv2.perspectiveTransform``: ``M`` is (n+1)x(n+1) for
    (..., n) points. Returns the transformed points, same shape as input.
    """
    points = torch.as_tensor(points)
    n = points.shape[-1]
    M = torch.as_tensor(M, dtype=points.dtype,
                        device=points.device).reshape(n + 1, n + 1)
    h = apply_affine(M, list(points.unbind(-1)))
    return torch.stack([c / h[-1] for c in h[:-1]], dim=-1)


def project_points(object_points, rvec, tvec, camera_matrix, dist_coeffs=None):
    """Project 3D world points to image pixels — drop-in for ``cv2.projectPoints``.

    Applies the rigid transform (Rodrigues ``rvec`` or a 3x3 matrix,
    ``tvec``), pinhole division, lens distortion and the intrinsic matrix.

    Parameters
    ----------
    object_points : torch.Tensor
        (..., 3) world coordinates.
    rvec : array or tensor
        (3,) Rodrigues rotation vector (or a 3x3 matrix).
    tvec : array or tensor
        (3,) translation.
    camera_matrix : array or tensor
        3x3 intrinsics.
    dist_coeffs : array, tensor or None
        Distortion coefficients (any accepted length).

    Returns
    -------
    torch.Tensor
        (..., 2) pixel coordinates.
    """
    pts = torch.as_tensor(object_points)
    like = dict(dtype=pts.dtype, device=pts.device)
    rvec = torch.as_tensor(rvec, **like)
    R = rvec if rvec.numel() == 9 else rodrigues_to_matrix(rvec)
    R = R.reshape(3, 3)
    t = torch.as_tensor(tvec, **like).reshape(3, 1)
    K = torch.as_tensor(camera_matrix, **like).reshape(3, 3)

    X, Y, Z = apply_affine(torch.cat([R, t], dim=1), list(pts.unbind(-1)))
    dist = distort_normalized(torch.stack([X / Z, Y / Z], dim=-1),
                              dist_coeffs)
    u, v, _ = apply_affine(K, [dist[..., 0], dist[..., 1]])
    return torch.stack([u, v], dim=-1)
