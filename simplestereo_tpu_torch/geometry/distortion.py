"""
distortion
==========

Brown-Conrady lens distortion model (OpenCV-compatible rational model with
thin-prism and tilt terms), forward and inverse, on tensors: the port of
:mod:`simplestereo_tpu.geometry.distortion`.

Coefficient order follows OpenCV:
``(k1, k2, p1, p2[, k3[, k4, k5, k6[, s1, s2, s3, s4[, taux, tauy]]]])``
with accepted lengths 0, 4, 5, 8, 12 and 14.

Every function broadcasts over leading dimensions, computes in the dtype
of ``points`` and runs on its device. The 3x3 products are written out as
sums (:mod:`._small`), so no TF32 matmul can enter on the card.
"""

import torch

from ._small import apply_affine, inv_small, matmul_small

N_COEFFS = 14


def pad_dist_coeffs(dist_coeffs, dtype=torch.float32, device=None):
    """Normalize distortion coefficients to a length-14 vector.

    Accepts None (zero distortion) or any array of length 0/4/5/8/12/14.
    """
    if dist_coeffs is None:
        return torch.zeros(N_COEFFS, dtype=dtype, device=device)
    d = torch.as_tensor(dist_coeffs, dtype=dtype, device=device).reshape(-1)
    n = d.shape[0]
    if n > N_COEFFS:
        raise ValueError(f"Too many distortion coefficients: {n} > {N_COEFFS}")
    return torch.cat([d, torch.zeros(N_COEFFS - n, dtype=dtype,
                                     device=d.device)])


def _tilt_matrix(taux, tauy):
    """Projection matrix of the tilted-sensor model (OpenCV
    computeTiltProjectionMatrix), from two 0-d tensors.

    Rotates the image plane by tauy around y then taux around x, and
    re-projects onto z=1 keeping the principal ray fixed.
    """
    ctx, stx = torch.cos(taux), torch.sin(taux)
    cty, sty = torch.cos(tauy), torch.sin(tauy)
    z = torch.zeros_like(taux)
    # R = Rx(taux) @ Ry(tauy)  (OpenCV order)
    R = torch.stack([
        torch.stack([cty, z, -sty]),
        torch.stack([stx * sty, ctx, stx * cty]),
        torch.stack([ctx * sty, -stx, ctx * cty]),
    ])
    # Projective normalization so that (0,0,1) maps to (0,0,1).
    P = torch.stack([
        torch.stack([R[2, 2], z, -R[0, 2]]),
        torch.stack([z, R[2, 2], -R[1, 2]]),
        torch.stack([z, z, torch.ones_like(taux)]),
    ])
    return matmul_small(P, R)


def _project(M, x, y):
    """(x, y, 1) @ M.T, divided by its last coordinate."""
    hx, hy, hw = apply_affine(M, [x, y])
    return hx / hw, hy / hw


def distort_normalized(points, dist_coeffs):
    """Apply lens distortion to normalized image coordinates.

    Parameters
    ----------
    points : torch.Tensor
        (..., 2) undistorted normalized coordinates (x, y) on the z=1 plane.
    dist_coeffs : array, tensor or None
        Distortion coefficients, any accepted length.

    Returns
    -------
    torch.Tensor
        (..., 2) distorted normalized coordinates.
    """
    points = torch.as_tensor(points)
    d = pad_dist_coeffs(dist_coeffs, points.dtype, points.device)
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4, taux, tauy = d.unbind(0)

    x = points[..., 0]
    y = points[..., 1]
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2

    radial = (1.0 + k1 * r2 + k2 * r4 + k3 * r6) / (1.0 + k4 * r2 + k5 * r4 + k6 * r6)
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) + s1 * r2 + s2 * r4
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y + s3 * r2 + s4 * r4

    # Tilted sensor model: T is exactly the identity when taux=tauy=0, so
    # applying it unconditionally needs no host read of the coefficients.
    return torch.stack(_project(_tilt_matrix(taux, tauy), xd, yd), dim=-1)


def undistort_normalized(points, dist_coeffs, iterations=10):
    """Invert lens distortion on normalized coordinates.

    Fixed-point compensation iteration, the same scheme as OpenCV's
    ``cvUndistortPointsInternal`` (which uses 5 iterations; the default
    here is 10, as in the JAX package).

    Parameters
    ----------
    points : torch.Tensor
        (..., 2) distorted normalized coordinates.
    dist_coeffs : array, tensor or None
    iterations : int
        Number of fixed-point iterations.

    Returns
    -------
    torch.Tensor
        (..., 2) undistorted normalized coordinates.
    """
    points = torch.as_tensor(points)
    d = pad_dist_coeffs(dist_coeffs, points.dtype, points.device)
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4, taux, tauy = d.unbind(0)

    # Undo tilt first (inverse homography of the tilt projection).
    Tinv = inv_small(_tilt_matrix(taux, tauy))
    x0, y0 = _project(Tinv, points[..., 0], points[..., 1])

    x, y = x0, y0
    for _ in range(iterations):
        r2 = x * x + y * y
        r4 = r2 * r2
        r6 = r4 * r2
        icdist = (1.0 + k4 * r2 + k5 * r4 + k6 * r6) / (1.0 + k1 * r2 + k2 * r4 + k3 * r6)
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x) + s1 * r2 + s2 * r4
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y + s3 * r2 + s4 * r4
        x, y = (x0 - dx) * icdist, (y0 - dy) * icdist
    return torch.stack([x, y], dim=-1)


def _matrix(m, like, rows=3):
    """``m`` as a (rows, -1) tensor in ``like``'s dtype and device."""
    return torch.as_tensor(m, dtype=like.dtype,
                           device=like.device).reshape(rows, -1)


def undistort_points(points, camera_matrix, dist_coeffs, R=None, P=None,
                     iterations=10):
    """Pixel-domain point undistortion — drop-in for ``cv2.undistortPoints``.

    Normalizes through ``camera_matrix``, inverts distortion, then applies
    the optional rectification transform ``R`` (a 3x3 homography/rotation in
    normalized space) and re-projects through ``P`` (3x3 or 3x4) if given.

    Parameters
    ----------
    points : torch.Tensor
        (..., 2) pixel coordinates.
    camera_matrix : array or tensor
        3x3 intrinsic matrix.
    dist_coeffs : array, tensor or None
    R : array or tensor, optional
        3x3 transform applied after undistortion (in normalized space).
    P : array or tensor, optional
        3x3 or 3x4 new projection matrix applied last.

    Returns
    -------
    torch.Tensor
        (..., 2) output coordinates: normalized if ``P`` is None, else pixels.
    """
    points = torch.as_tensor(points)
    Kinv = inv_small(_matrix(camera_matrix, points))
    norm = torch.stack(_project(Kinv, points[..., 0], points[..., 1]), dim=-1)

    und = undistort_normalized(norm, dist_coeffs, iterations=iterations)

    M = torch.eye(3, dtype=points.dtype, device=points.device)
    if R is not None:
        M = matmul_small(_matrix(R, points), M)
    if P is not None:
        M = matmul_small(_matrix(P, points)[:, :3], M)
    return torch.stack(_project(M, und[..., 0], und[..., 1]), dim=-1)


def distort_points(points, camera_matrix, dist_coeffs, P=None):
    """Pixel-domain forward distortion (inverse of :func:`undistort_points`).

    Parameters
    ----------
    points : torch.Tensor
        (..., 2) undistorted pixel coordinates (w.r.t. ``camera_matrix``).
    camera_matrix : array or tensor
        3x3 intrinsic matrix used to normalize.
    dist_coeffs : array, tensor or None
    P : array or tensor, optional
        3x3 matrix to re-apply after distortion; defaults to camera_matrix.

    Returns
    -------
    torch.Tensor
        (..., 2) distorted pixel coordinates.
    """
    points = torch.as_tensor(points)
    K = _matrix(camera_matrix, points)
    Kinv = inv_small(K)
    norm = torch.stack(_project(Kinv, points[..., 0], points[..., 1]), dim=-1)
    dist = distort_normalized(norm, dist_coeffs)
    Pm = K if P is None else _matrix(P, points)
    return torch.stack(_project(Pm, dist[..., 0], dist[..., 1]), dim=-1)
