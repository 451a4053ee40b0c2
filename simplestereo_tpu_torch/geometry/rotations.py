"""
rotations
=========

Rodrigues axis-angle <-> rotation-matrix conversions on tensors: the port
of :mod:`simplestereo_tpu.geometry.rotations`. Both run in the input's
dtype and on its device, with no host read (branches are ``torch.where``).
"""

import math

import torch

from ._small import matmul_small


def _skew(v):
    z = torch.zeros_like(v[0])
    return torch.stack([
        torch.stack([z, -v[2], v[1]]),
        torch.stack([v[2], z, -v[0]]),
        torch.stack([-v[1], v[0], z]),
    ])


def rodrigues_to_matrix(rvec):
    """Convert a Rodrigues rotation vector to a 3x3 rotation matrix.

    Uses the standard axis-angle exponential map with a Taylor-safe
    small-angle branch.

    Parameters
    ----------
    rvec : torch.Tensor
        Shape (3,) rotation vector; direction is the axis, norm the angle.

    Returns
    -------
    torch.Tensor
        Shape (3, 3) rotation matrix.
    """
    rvec = torch.as_tensor(rvec).reshape(3)
    theta2 = torch.sum(rvec * rvec)
    theta = torch.sqrt(theta2 + 1e-32)

    # sin(t)/t and (1-cos(t))/t^2 with series fallbacks near zero.
    small = theta2 < 1e-12
    sinc = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    cosc = torch.where(small, 0.5 - theta2 / 24.0,
                       (1.0 - torch.cos(theta)) / theta2)

    K = _skew(rvec)
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device)
    return eye + sinc * K + cosc * matmul_small(K, K)


def matrix_to_rodrigues(R):
    """Convert a 3x3 rotation matrix to a Rodrigues vector.

    Inverse of :func:`rodrigues_to_matrix`. Stable for angles near 0 and
    near pi (uses the diagonal-based axis extraction in the pi branch).

    Parameters
    ----------
    R : torch.Tensor
        Shape (3, 3) rotation matrix.

    Returns
    -------
    torch.Tensor
        Shape (3,) rotation vector.
    """
    R = torch.as_tensor(R).reshape(3, 3)
    trace = R[0, 0] + R[1, 1] + R[2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)

    # Antisymmetric part gives axis*sin(theta).
    v = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    sin_theta = torch.sqrt(torch.clamp(torch.sum(v * v), min=1e-32)) * 0.5

    # Generic branch: axis = v / (2 sin t), rvec = axis * t.
    generic = v * (theta / torch.clamp(2.0 * sin_theta, min=1e-12))
    # Small-angle branch: rvec ~ v/2 (first order).
    small = v * 0.5

    # Near pi: axis from diagonal of (R + I)/2 = a a^T style extraction.
    A = (R + torch.eye(3, dtype=R.dtype, device=R.device)) * 0.5
    diag = torch.clamp(torch.diagonal(A), min=0.0)
    axis_mag = torch.sqrt(diag + 1e-32)
    # Pick the largest diagonal as the reference component to fix signs.
    k = torch.argmax(diag)
    col = A[:, k] / torch.clamp(axis_mag[k], min=1e-12)
    axis_pi = col / torch.clamp(torch.linalg.vector_norm(col), min=1e-12)
    # Keep sign consistent with antisymmetric part when it is not exactly 0.
    sign = torch.where(torch.sum(axis_pi * v) < 0.0, -1.0, 1.0)
    near_pi = axis_pi * sign * theta

    is_small = theta < 1e-6
    is_pi = math.pi - theta < 1e-4
    return torch.where(is_small, small, torch.where(is_pi, near_pi, generic))
