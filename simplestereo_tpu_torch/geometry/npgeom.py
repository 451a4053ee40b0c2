"""
npgeom
======

NumPy float64 geometry primitives for *host-side control-plane* use: rig
algebra, corner bookkeeping, rectification fitting.

A copy of :mod:`simplestereo_tpu.geometry.npgeom` (numpy only; importing
the original would import jax through its package). A 4-point corner
transform costs less on the host than one launch on the card. The torch
versions in :mod:`.distortion` / :mod:`.projection` are for dense work on
tensors (map building). tests/test_torch_geometry.py holds this copy to
the original.
"""

import numpy as np

N_COEFFS = 14


def pad_dist_coeffs(dist_coeffs):
    if dist_coeffs is None:
        return np.zeros(N_COEFFS)
    d = np.asarray(dist_coeffs, np.float64).reshape(-1)
    if d.shape[0] > N_COEFFS:
        raise ValueError(f"Too many distortion coefficients: {d.shape[0]}")
    return np.concatenate([d, np.zeros(N_COEFFS - d.shape[0])])


def _tilt_matrix(taux, tauy):
    ctx, stx = np.cos(taux), np.sin(taux)
    cty, sty = np.cos(tauy), np.sin(tauy)
    R = np.array(
        [
            [cty, 0.0, -sty],
            [stx * sty, ctx, stx * cty],
            [ctx * sty, -stx, ctx * cty],
        ]
    )
    P = np.array([[R[2, 2], 0.0, -R[0, 2]], [0.0, R[2, 2], -R[1, 2]], [0, 0, 1.0]])
    return P @ R


def distort_normalized(points, dist_coeffs):
    """NumPy twin of geometry.distortion.distort_normalized."""
    d = pad_dist_coeffs(dist_coeffs)
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4, taux, tauy = d
    pts = np.asarray(points, np.float64)
    x, y = pts[..., 0], pts[..., 1]
    r2 = x * x + y * y
    r4, r6 = r2 * r2, r2 * r2 * r2
    radial = (1 + k1 * r2 + k2 * r4 + k3 * r6) / (1 + k4 * r2 + k5 * r4 + k6 * r6)
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x) + s1 * r2 + s2 * r4
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y + s3 * r2 + s4 * r4
    if taux != 0.0 or tauy != 0.0:
        T = _tilt_matrix(taux, tauy)
        h = np.stack([xd, yd, np.ones_like(xd)], axis=-1) @ T.T
        xd, yd = h[..., 0] / h[..., 2], h[..., 1] / h[..., 2]
    return np.stack([xd, yd], axis=-1)


def undistort_normalized(points, dist_coeffs, iterations=10):
    """NumPy twin of geometry.distortion.undistort_normalized."""
    d = pad_dist_coeffs(dist_coeffs)
    k1, k2, p1, p2, k3, k4, k5, k6, s1, s2, s3, s4, taux, tauy = d
    pts = np.asarray(points, np.float64)
    x0, y0 = pts[..., 0].copy(), pts[..., 1].copy()
    if taux != 0.0 or tauy != 0.0:
        Tinv = np.linalg.inv(_tilt_matrix(taux, tauy))
        h = np.stack([x0, y0, np.ones_like(x0)], axis=-1) @ Tinv.T
        x0, y0 = h[..., 0] / h[..., 2], h[..., 1] / h[..., 2]
    x, y = x0.copy(), y0.copy()
    for _ in range(iterations):
        r2 = x * x + y * y
        r4, r6 = r2 * r2, r2 * r2 * r2
        icdist = (1 + k4 * r2 + k5 * r4 + k6 * r6) / (1 + k1 * r2 + k2 * r4 + k3 * r6)
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x) + s1 * r2 + s2 * r4
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y + s3 * r2 + s4 * r4
        x = (x0 - dx) * icdist
        y = (y0 - dy) * icdist
    return np.stack([x, y], axis=-1)


def undistort_points(points, camera_matrix, dist_coeffs, R=None, P=None,
                     iterations=10):
    """NumPy twin of geometry.distortion.undistort_points."""
    pts = np.asarray(points, np.float64)
    K = np.asarray(camera_matrix, np.float64).reshape(3, 3)
    h = np.concatenate([pts, np.ones(pts.shape[:-1] + (1,))], axis=-1)
    h = h @ np.linalg.inv(K).T
    norm = h[..., :2] / h[..., 2:3]
    und = undistort_normalized(norm, dist_coeffs, iterations)
    M = np.eye(3)
    if R is not None:
        M = np.asarray(R, np.float64).reshape(3, 3) @ M
    if P is not None:
        Pm = np.asarray(P, np.float64).reshape(3, -1)[:, :3]
        M = Pm @ M
    h = np.concatenate([und, np.ones(und.shape[:-1] + (1,))], axis=-1) @ M.T
    return h[..., :2] / h[..., 2:3]


def distort_points(points, camera_matrix, dist_coeffs, P=None):
    """NumPy twin of geometry.distortion.distort_points."""
    pts = np.asarray(points, np.float64)
    K = np.asarray(camera_matrix, np.float64).reshape(3, 3)
    h = np.concatenate([pts, np.ones(pts.shape[:-1] + (1,))], axis=-1)
    h = h @ np.linalg.inv(K).T
    norm = h[..., :2] / h[..., 2:3]
    dist = distort_normalized(norm, dist_coeffs)
    Pm = K if P is None else np.asarray(P, np.float64).reshape(3, 3)
    h = np.concatenate([dist, np.ones(dist.shape[:-1] + (1,))], axis=-1) @ Pm.T
    return h[..., :2] / h[..., 2:3]


def perspective_transform(points, M):
    """NumPy twin of geometry.projection.perspective_transform."""
    pts = np.asarray(points, np.float64)
    n = pts.shape[-1]
    M = np.asarray(M, np.float64).reshape(n + 1, n + 1)
    h = np.concatenate([pts, np.ones(pts.shape[:-1] + (1,))], axis=-1) @ M.T
    return h[..., :-1] / h[..., -1:]


def rodrigues_to_matrix(rvec):
    """NumPy twin of geometry.rotations.rodrigues_to_matrix."""
    r = np.asarray(rvec, np.float64).reshape(3)
    theta = np.linalg.norm(r)
    if theta < 1e-12:
        K = np.array([[0, -r[2], r[1]], [r[2], 0, -r[0]], [-r[1], r[0], 0]])
        return np.eye(3) + K
    k = r / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def matrix_to_rodrigues(R):
    """NumPy twin of geometry.rotations.matrix_to_rodrigues."""
    R = np.asarray(R, np.float64).reshape(3, 3)
    cos_theta = np.clip((np.trace(R) - 1) / 2, -1.0, 1.0)
    theta = np.arccos(cos_theta)
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if theta < 1e-8:
        return v / 2
    if np.pi - theta < 1e-6:
        A = (R + np.eye(3)) / 2
        diag = np.clip(np.diagonal(A), 0, None)
        k = int(np.argmax(diag))
        axis = A[:, k] / max(np.sqrt(diag[k]), 1e-12)
        axis = axis / np.linalg.norm(axis)
        if np.dot(axis, v) < 0:
            axis = -axis
        return axis * theta
    return v * (theta / (2 * np.sin(theta)))


def project_points(object_points, rvec, tvec, camera_matrix, dist_coeffs=None):
    """NumPy twin of geometry.projection.project_points."""
    pts = np.asarray(object_points, np.float64)
    rvec = np.asarray(rvec, np.float64)
    R = rvec.reshape(3, 3) if rvec.size == 9 else rodrigues_to_matrix(rvec)
    t = np.asarray(tvec, np.float64).reshape(3)
    K = np.asarray(camera_matrix, np.float64).reshape(3, 3)
    cam = pts @ R.T + t
    norm = cam[..., :2] / cam[..., 2:3]
    dist = distort_normalized(norm, dist_coeffs)
    h = np.concatenate([dist, np.ones(dist.shape[:-1] + (1,))], axis=-1) @ K.T
    return h[..., :2]
