"""
ba
==

Bundle adjustment core for camera calibration: Zhang-style initialization
plus Levenberg-Marquardt refinement, host float64 numpy.

A copy of :mod:`simplestereo_tpu.calibration.ba` (numpy only; importing
the original would import jax through its package), held equal to it by
tests/test_torch_calibration.py. Jacobians are computed by complex-step
differentiation (machine precision; every function below is complex-safe:
norms via sqrt(sum(x*x)), never abs). The device Gauss-Newton for large
view counts is :mod:`.sharded`.

Distortion follows the Brown-Conrady model with OpenCV coefficient
ordering (k1 k2 p1 p2 k3 k4 k5 k6 s1 s2 s3 s4 taux tauy); the number of
optimized coefficients is 0/4/5/8/12/14.
"""

import numpy as np

_H_STEP = 1e-200  # complex-step size: derivative = Im(f(x+ih))/h, exact


# --------------------------------------------------------------------------
# complex-safe projection chain
# --------------------------------------------------------------------------

def _rodrigues(rvec):
    """Rotation vector -> matrix, complex-step safe (no abs/conj)."""
    rvec = np.asarray(rvec)
    theta2 = (rvec * rvec).sum()
    theta = np.sqrt(theta2 + 0j) if np.iscomplexobj(rvec) else np.sqrt(theta2)
    if (theta.real if np.iscomplexobj(rvec) else theta) < 1e-12:
        # 2nd-order Taylor keeps derivatives correct at theta ~ 0
        K = np.array([[0, -rvec[2], rvec[1]],
                      [rvec[2], 0, -rvec[0]],
                      [-rvec[1], rvec[0], 0]], dtype=rvec.dtype)
        return np.eye(3, dtype=rvec.dtype) + K + 0.5 * (K @ K)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]],
                  [k[2], 0, -k[0]],
                  [-k[1], k[0], 0]], dtype=rvec.dtype)
    return (np.eye(3, dtype=rvec.dtype) + np.sin(theta) * K
            + (1.0 - np.cos(theta)) * (K @ K))


def _rodrigues_batch(rvecs):
    """(V, 3) rotation vectors -> (V, 3, 3) matrices, complex-step safe.

    Vectorized twin of :func:`_rodrigues` (the LM residuals are the hot
    path: one call per view per parameter per iteration adds up to 1e5+
    tiny-array calls — batching them is a ~15x calibration speedup)."""
    rvecs = np.asarray(rvecs)
    V = rvecs.shape[0]
    theta2 = (rvecs * rvecs).sum(axis=1)
    theta = np.sqrt(theta2 + 0j) if np.iscomplexobj(rvecs) \
        else np.sqrt(theta2)
    small = theta.real < 1e-12
    safe = np.where(small, 1.0, theta)
    k = rvecs / safe[:, None]
    K = np.zeros((V, 3, 3), dtype=rvecs.dtype)
    K[:, 0, 1], K[:, 0, 2] = -k[:, 2], k[:, 1]
    K[:, 1, 0], K[:, 1, 2] = k[:, 2], -k[:, 0]
    K[:, 2, 0], K[:, 2, 1] = -k[:, 1], k[:, 0]
    KK = K @ K
    eye = np.broadcast_to(np.eye(3, dtype=rvecs.dtype), (V, 3, 3))
    R = (eye + np.sin(theta)[:, None, None] * K
         + (1.0 - np.cos(theta))[:, None, None] * KK)
    if small.any():
        # 2nd-order Taylor at theta ~ 0 (K here is scaled by 1/safe=1)
        Ks = np.zeros((V, 3, 3), dtype=rvecs.dtype)
        Ks[:, 0, 1], Ks[:, 0, 2] = -rvecs[:, 2], rvecs[:, 1]
        Ks[:, 1, 0], Ks[:, 1, 2] = rvecs[:, 2], -rvecs[:, 0]
        Ks[:, 2, 0], Ks[:, 2, 1] = -rvecs[:, 1], rvecs[:, 0]
        R_small = eye + Ks + 0.5 * (Ks @ Ks)
        R = np.where(small[:, None, None], R_small, R)
    return R


def _distort(xy, dist):
    """Normalized (..., 2) -> distorted normalized, 14-coeff
    Brown-Conrady; broadcasts over leading axes.

    Parity: simplestereo_tpu_torch.geometry.distortion.distort_normalized /
    reference points.py:179-220 extended per calibration.py:1048-1094.
    """
    x, y = xy[..., 0], xy[..., 1]
    k = np.zeros(14, dtype=xy.dtype)
    k[: len(dist)] = dist
    r2 = x * x + y * y
    r4, r6 = r2 * r2, r2 * r2 * r2
    radial = ((1 + k[0] * r2 + k[1] * r4 + k[4] * r6)
              / (1 + k[5] * r2 + k[6] * r4 + k[7] * r6))
    xd = (x * radial + 2 * k[2] * x * y + k[3] * (r2 + 2 * x * x)
          + k[8] * r2 + k[9] * r4)
    yd = (y * radial + k[2] * (r2 + 2 * y * y) + 2 * k[3] * x * y
          + k[10] * r2 + k[11] * r4)
    if k[12] != 0 or k[13] != 0:
        # tilted sensor model (tauX, tauY): x' = (R33*px - R13*pz)/pz
        ctx, stx = np.cos(k[12]), np.sin(k[12])
        cty, sty = np.cos(k[13]), np.sin(k[13])
        R = np.array([[cty, stx * sty, -ctx * sty],
                      [0, ctx, stx],
                      [sty, -stx * cty, ctx * cty]], dtype=xy.dtype)
        pz = R[2, 0] * xd + R[2, 1] * yd + R[2, 2]
        px = R[0, 0] * xd + R[0, 1] * yd + R[0, 2]
        py = R[1, 0] * xd + R[1, 1] * yd + R[1, 2]
        xd = (R[2, 2] * px - R[0, 2] * pz) / pz
        yd = (R[2, 2] * py - R[1, 2] * pz) / pz
    return np.stack([xd, yd], axis=-1)


def project_points(obj, rvec, tvec, fx, fy, cx, cy, dist):
    """(N,3) world points -> (N,2) pixels. Complex-step safe.

    ``rvec`` may be a (3,) rotation vector or an already-built (3,3)
    rotation matrix (used by stereo residuals to keep composition
    differentiable without a log-map roundtrip)."""
    rvec = np.asarray(rvec)
    R = rvec if rvec.shape == (3, 3) else _rodrigues(rvec)
    p = obj @ R.T + tvec[None, :]
    xy = p[:, :2] / p[:, 2:3]
    xy = _distort(xy, dist)
    u = fx * xy[:, 0] + cx
    v = fy * xy[:, 1] + cy
    return np.stack([u, v], axis=1)


def _project_points_batch(obj, R, t, fx, fy, cx, cy, dist):
    """Batched projection: (V,N,3) points, (V,3,3) rotations, (V,3)
    translations -> (V,N,2) pixels. Complex-step safe (shares _distort
    with the per-view :func:`project_points`)."""
    p = obj @ np.swapaxes(R, 1, 2) + t[:, None, :]
    xy = p[..., :2] / p[..., 2:3]
    xy = _distort(xy, dist)
    u = fx * xy[..., 0] + cx
    v = fy * xy[..., 1] + cy
    return np.stack([u, v], axis=-1)


# --------------------------------------------------------------------------
# generic Levenberg-Marquardt with complex-step Jacobian
# --------------------------------------------------------------------------

def complex_step_jacobian(fn, x):
    """J[i, j] = d fn(x)_i / d x_j via complex step (machine precision)."""
    x = np.asarray(x, np.float64)
    n = x.size
    J = np.empty((fn(x).size, n))
    for j in range(n):
        xc = x.astype(np.complex128)
        xc[j] += 1j * _H_STEP
        J[:, j] = fn(xc).imag / _H_STEP
    return J


def levenberg_marquardt(residual_fn, x0, max_iter=100, tol=1e-10,
                        lam0=1e-3):
    """Dense LM. Returns (x, rms_history). residual_fn must be
    complex-step safe (accepts complex x, returns complex residuals)."""
    x = np.asarray(x0, np.float64).copy()
    lam = lam0
    r = residual_fn(x).real
    cost = float(r @ r)
    history = [cost]
    for _ in range(max_iter):
        J = complex_step_jacobian(residual_fn, x)
        JtJ = J.T @ J
        g = J.T @ r
        improved = False
        for _ in range(12):
            A = JtJ + lam * np.diag(np.maximum(np.diag(JtJ), 1e-12))
            try:
                dx = np.linalg.solve(A, -g)
            except np.linalg.LinAlgError:
                lam *= 10
                continue
            x_new = x + dx
            r_new = residual_fn(x_new).real
            c_new = float(r_new @ r_new)
            if c_new < cost:
                x, r, cost = x_new, r_new, c_new
                lam = max(lam * 0.3, 1e-14)
                improved = True
                history.append(cost)
                break
            lam *= 10
        if not improved or (len(history) > 1
                            and history[-2] - history[-1]
                            < tol * max(history[-2], 1e-30)):
            break
    return x, history


# --------------------------------------------------------------------------
# Zhang initialization
# --------------------------------------------------------------------------

def _homography_dlt(src, dst):
    """Normalized DLT homography (src (N,2) -> dst (N,2))."""
    def normalize(p):
        c = p.mean(0)
        s = np.sqrt(2.0) / max(np.mean(np.linalg.norm(p - c, axis=1)), 1e-12)
        T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1.0]])
        return (p - c) * s, T

    sp, Ts = normalize(np.asarray(src, np.float64))
    dp, Td = normalize(np.asarray(dst, np.float64))
    n = len(sp)
    A = np.zeros((2 * n, 9))
    A[0::2, 0:2] = sp
    A[0::2, 2] = 1
    A[0::2, 6:8] = -dp[:, :1] * sp
    A[0::2, 8] = -dp[:, 0]
    A[1::2, 3:5] = sp
    A[1::2, 5] = 1
    A[1::2, 6:8] = -dp[:, 1:2] * sp
    A[1::2, 8] = -dp[:, 1]
    _, _, Vt = np.linalg.svd(A)
    H = Vt[-1].reshape(3, 3)
    H = np.linalg.inv(Td) @ H @ Ts
    return H / H[2, 2]


def _zhang_intrinsics(Hs, image_size):
    """Closed-form K from >=2 plane homographies (Zhang 2000 eq. 8-9)."""
    def v(H, i, j):
        return np.array([
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j]])

    V = []
    for H in Hs:
        V.append(v(H, 0, 1))
        V.append(v(H, 0, 0) - v(H, 1, 1))
    V = np.asarray(V)
    if len(Hs) == 2:  # assume zero skew to regularize
        V = np.vstack([V, [0, 1, 0, 0, 0, 0]])
    _, _, Vt = np.linalg.svd(V)
    b11, b12, b22, b13, b23, b33 = Vt[-1]
    try:
        cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
        lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
        fx = np.sqrt(lam / b11)
        fy = np.sqrt(lam * b11 / (b11 * b22 - b12 * b12))
        cx = -b13 * fx * fx / lam
        if not (np.isfinite([fx, fy, cx, cy]).all() and fx > 0 and fy > 0):
            raise FloatingPointError
    except (FloatingPointError, ZeroDivisionError):
        # fall back to a generic initialization from the image size
        w, h = image_size
        fx = fy = 1.2 * max(w, h)
        cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    return fx, fy, cx, cy


def _extrinsics_from_h(H, K):
    """Per-view pose from plane homography (Zhang 2000 §3.1)."""
    A = np.linalg.inv(K) @ H
    lam = 1.0 / max(np.linalg.norm(A[:, 0]), 1e-12)
    if A[2, 2] * lam < 0:  # points must be in front of the camera
        lam = -lam
    r1, r2 = lam * A[:, 0], lam * A[:, 1]
    t = lam * A[:, 2]
    r3 = np.cross(r1, r2)
    Q = np.stack([r1, r2, r3], axis=1)
    U, _, Vt = np.linalg.svd(Q)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = U @ np.diag([1, 1, -1]) @ Vt
    return _rodrigues_inv(R), t


def _rodrigues_inv(R):
    """Rotation matrix -> rotation vector (host f64)."""
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(c)
    if theta < 1e-12:
        return np.zeros(3)
    if np.pi - theta < 1e-6:
        # antipodal: extract axis from R + I
        M = (R + np.eye(3)) / 2.0
        axis = np.sqrt(np.maximum(np.diag(M), 0))
        axis /= max(np.linalg.norm(axis), 1e-12)
        # fix signs from off-diagonals
        if M[0, 1] < 0:
            axis[1] = -axis[1]
        if M[0, 2] < 0:
            axis[2] = -axis[2]
        return axis * theta
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return w / (2.0 * np.sin(theta)) * theta


# --------------------------------------------------------------------------
# single-camera calibration
# --------------------------------------------------------------------------

def _n_dist_params(num_coeffs):
    """Reference flag semantics (calibration.py:1048-1094): how many
    leading coefficients are optimized; the rest stay 0."""
    if num_coeffs not in (0, 4, 5, 8, 12, 14):
        raise ValueError("Distortion coefficients must be 0, 4, 5, 8, 12 "
                         "or 14!")
    return num_coeffs


def calibrate_camera(object_points, image_points, image_size, num_coeffs=5,
                     K_init=None, dist_init=None, fix_intrinsic=False,
                     max_iter=60):
    """Zhang init + LM refine. Mirrors ``cv2.calibrateCamera``.

    object_points : list of (N,3) f64 per view (planar, Z=0 for init)
    image_points : list of (N,2) f64 per view
    Returns (rms, K (3,3), dist (num_coeffs,), rvecs, tvecs).
    """
    nd = _n_dist_params(num_coeffs)
    V = len(object_points)
    obj = [np.asarray(o, np.float64) for o in object_points]
    img = [np.asarray(i, np.float64).reshape(-1, 2) for i in image_points]

    if K_init is None:
        Hs = [_homography_dlt(o[:, :2], i) for o, i in zip(obj, img)]
        fx, fy, cx, cy = _zhang_intrinsics(Hs, image_size)
        K_init = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    else:
        K_init = np.asarray(K_init, np.float64)
        Hs = [_homography_dlt(o[:, :2], i) for o, i in zip(obj, img)]
    dist0 = np.zeros(nd)
    if dist_init is not None:
        dist0[: len(dist_init)] = np.asarray(dist_init)[:nd]

    poses = [_extrinsics_from_h(H, K_init) for H in Hs]

    # parameter vector: [fx fy cx cy dist... | rvec tvec per view];
    # with fix_intrinsic the head is dropped (poses only), keeping the
    # normal equations full-rank.
    intr0 = np.array([K_init[0, 0], K_init[1, 1], K_init[0, 2], K_init[1, 2]])
    pose0 = [np.concatenate([r, t]) for r, t in poses]
    n_intr = 0 if fix_intrinsic else 4 + nd
    if fix_intrinsic:
        x0 = np.concatenate(pose0)
    else:
        x0 = np.concatenate([intr0, dist0] + pose0)

    def unpack(x):
        if fix_intrinsic:
            fx, fy, cx, cy = intr0
            dist = dist0.astype(x.dtype)
        else:
            fx, fy, cx, cy = x[0], x[1], x[2], x[3]
            dist = x[4:n_intr]
        poses_x = x[n_intr:].reshape(V, 6)
        return fx, fy, cx, cy, dist, poses_x

    # Same corner count in every view -> one batched projection per
    # residual call (the LM Jacobian calls this once per parameter).
    same_n = len({o.shape[0] for o in obj}) == 1
    obj_arr = np.stack(obj) if same_n else None
    img_arr = np.stack(img) if same_n else None

    def residuals(x):
        fx, fy, cx, cy, dist, poses_x = unpack(x)
        if same_n:
            R = _rodrigues_batch(poses_x[:, :3])
            pr = _project_points_batch(
                obj_arr.astype(x.dtype), R, poses_x[:, 3:],
                fx, fy, cx, cy, dist)
            return (pr - img_arr).reshape(-1)
        out = []
        for vi in range(V):
            pr = project_points(obj[vi].astype(x.dtype), poses_x[vi, :3],
                                poses_x[vi, 3:], fx, fy, cx, cy, dist)
            out.append((pr - img[vi]).ravel())
        return np.concatenate(out)

    x, _ = levenberg_marquardt(residuals, x0, max_iter=max_iter)
    fx, fy, cx, cy, dist, poses_x = unpack(x)
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    r = residuals(x).real
    n_pts = sum(len(o) for o in obj)
    rms = float(np.sqrt((r * r).sum() / n_pts))
    rvecs = [poses_x[i, :3].copy() for i in range(V)]
    tvecs = [poses_x[i, 3:].copy() for i in range(V)]
    return rms, K, dist.real.copy(), rvecs, tvecs


# --------------------------------------------------------------------------
# stereo calibration
# --------------------------------------------------------------------------

def stereo_calibrate(object_points, image_points1, image_points2,
                     image_size, K1=None, dist1=None, K2=None, dist2=None,
                     num_coeffs=5, fix_intrinsic=False, max_iter=60):
    """Joint two-camera calibration. Mirrors ``cv2.stereoCalibrate``.

    Optimizes intrinsics (unless fix_intrinsic), per-view camera-1 poses,
    and the fixed relative pose (R, T) with camera 2 = R @ X1 + T.
    Returns (rms, K1, dist1, K2, dist2, R, T, E, F, perViewErrors).
    """
    nd = _n_dist_params(num_coeffs)
    V = len(object_points)
    obj = [np.asarray(o, np.float64) for o in object_points]
    im1 = [np.asarray(i, np.float64).reshape(-1, 2) for i in image_points1]
    im2 = [np.asarray(i, np.float64).reshape(-1, 2) for i in image_points2]

    if K1 is None or K2 is None:
        _, K1, dist1, rv1, tv1 = calibrate_camera(
            obj, im1, image_size, num_coeffs=nd)
        _, K2, dist2, rv2, tv2 = calibrate_camera(
            obj, im2, image_size, num_coeffs=nd)
    else:
        _, _, _, rv1, tv1 = calibrate_camera(
            obj, im1, image_size, num_coeffs=nd, K_init=K1, dist_init=dist1,
            fix_intrinsic=True, max_iter=30)
        _, _, _, rv2, tv2 = calibrate_camera(
            obj, im2, image_size, num_coeffs=nd, K_init=K2, dist_init=dist2,
            fix_intrinsic=True, max_iter=30)
    dist1 = np.zeros(nd) if dist1 is None else np.asarray(
        dist1, np.float64).ravel()[:nd]
    dist2 = np.zeros(nd) if dist2 is None else np.asarray(
        dist2, np.float64).ravel()[:nd]
    d1 = np.zeros(nd)
    d1[: len(dist1)] = dist1
    d2 = np.zeros(nd)
    d2[: len(dist2)] = dist2

    # init relative pose: median over views of R2 R1^T, T2 - R T1
    Rs, Ts = [], []
    for r1, t1, r2, t2 in zip(rv1, tv1, rv2, tv2):
        R1, R2 = _rodrigues(r1), _rodrigues(r2)
        Rrel = R2 @ R1.T
        Rs.append(_rodrigues_inv(Rrel))
        Ts.append(t2 - Rrel @ t1)
    r_rel = np.median(np.asarray(Rs), axis=0)
    t_rel = np.median(np.asarray(Ts), axis=0)

    intr10 = np.array([K1[0, 0], K1[1, 1], K1[0, 2], K1[1, 2]])
    intr20 = np.array([K2[0, 0], K2[1, 1], K2[0, 2], K2[1, 2]])
    pose0 = [np.concatenate([r, t]) for r, t in zip(rv1, tv1)]
    if fix_intrinsic:
        x0 = np.concatenate([r_rel, t_rel] + pose0)
        n_head = 6
    else:
        x0 = np.concatenate([r_rel, t_rel, intr10, d1, intr20, d2] + pose0)
        n_head = 6 + 2 * (4 + nd)

    def unpack(x):
        r_rel, t_rel = x[0:3], x[3:6]
        if fix_intrinsic:
            i1, dd1 = intr10, d1.astype(x.dtype)
            i2, dd2 = intr20, d2.astype(x.dtype)
        else:
            i1 = x[6:10]
            dd1 = x[10:10 + nd]
            i2 = x[10 + nd:14 + nd]
            dd2 = x[14 + nd:n_head]
        poses = x[n_head:].reshape(V, 6)
        return r_rel, t_rel, i1, dd1, i2, dd2, poses

    # Same corner count in every view -> both cameras project in two
    # batched calls per residual evaluation (the hot path under the
    # complex-step Jacobian). Residual ordering matches the per-view
    # loop exactly: [view0 cam1, view0 cam2, view1 cam1, ...].
    same_n = len({o.shape[0] for o in obj}) == 1
    obj_arr = np.stack(obj) if same_n else None
    im1_arr = np.stack(im1) if same_n else None
    im2_arr = np.stack(im2) if same_n else None

    def residuals(x):
        r_rel, t_rel, i1, dd1, i2, dd2, poses = unpack(x)
        Rrel = _rodrigues(r_rel)
        if same_n:
            o = obj_arr.astype(x.dtype)
            R1 = _rodrigues_batch(poses[:, :3])
            pr1 = _project_points_batch(o, R1, poses[:, 3:],
                                        i1[0], i1[1], i1[2], i1[3], dd1)
            R2 = Rrel[None] @ R1
            t2 = poses[:, 3:] @ Rrel.T + t_rel
            pr2 = _project_points_batch(o, R2, t2,
                                        i2[0], i2[1], i2[2], i2[3], dd2)
            r1 = (pr1 - im1_arr).reshape(V, -1)
            r2 = (pr2 - im2_arr).reshape(V, -1)
            return np.stack([r1, r2], axis=1).reshape(-1)
        out = []
        for vi in range(V):
            o = obj[vi].astype(x.dtype)
            pr1 = project_points(o, poses[vi, :3], poses[vi, 3:],
                                 i1[0], i1[1], i1[2], i1[3], dd1)
            out.append((pr1 - im1[vi]).ravel())
            R1 = _rodrigues(poses[vi, :3])
            R2 = Rrel @ R1
            t2 = Rrel @ poses[vi, 3:] + t_rel
            pr2 = project_points(o, R2, t2,
                                 i2[0], i2[1], i2[2], i2[3], dd2)
            out.append((pr2 - im2[vi]).ravel())
        return np.concatenate(out)

    x, _ = levenberg_marquardt(residuals, x0, max_iter=max_iter)
    r_rel, t_rel, i1, dd1, i2, dd2, poses = unpack(x)
    K1o = np.array([[i1[0], 0, i1[2]], [0, i1[1], i1[3]], [0, 0, 1.0]])
    K2o = np.array([[i2[0], 0, i2[2]], [0, i2[1], i2[3]], [0, 0, 1.0]])
    R = _rodrigues(r_rel)
    T = t_rel.reshape(3, 1)

    r = residuals(x).real
    n_pts = 2 * sum(len(o) for o in obj)
    rms = float(np.sqrt((r * r).sum() / n_pts))

    per_view = np.zeros((V, 2))
    idx = 0
    for vi in range(V):
        n = len(obj[vi]) * 2
        r1v = r[idx:idx + n]
        r2v = r[idx + n:idx + 2 * n]
        per_view[vi, 0] = np.sqrt((r1v * r1v).sum() / len(obj[vi]))
        per_view[vi, 1] = np.sqrt((r2v * r2v).sum() / len(obj[vi]))
        idx += 2 * n

    # E and F from the relative pose (same formulas as the rig class)
    Tx = np.array([[0, -T[2, 0], T[1, 0]],
                   [T[2, 0], 0, -T[0, 0]],
                   [-T[1, 0], T[0, 0], 0]])
    E = Tx @ R
    F = np.linalg.inv(K2o).T @ E @ np.linalg.inv(K1o)
    if abs(F[2, 2]) > 1e-15:
        F = F / F[2, 2]
    return (rms, K1o, dd1.real[:nd].copy(), K2o, dd2.real[:nd].copy(),
            R, T, E, F, per_view)
