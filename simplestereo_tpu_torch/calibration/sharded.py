"""
sharded
=======

Device-resident Gauss-Newton camera calibration for large view counts, the
port of :mod:`simplestereo_tpu.calibration.sharded` on one card.

Per-view Gauss-Newton blocks are built on the device with
``torch.func.jacfwd`` under ``torch.func.vmap`` and the intrinsic normal
equations are reduced over the views, the Schur-complement form:

    J_i = [A_i | B_i]   (A: d r_i / d intrinsics, B: d r_i / d pose_i)
    S   = sum_i A_i^T A_i - A_i^T B_i (B_i^T B_i)^-1 B_i^T A_i
    g   = sum_i A_i^T r_i - A_i^T B_i (B_i^T B_i)^-1 B_i^T r_i
    d_theta = -S^-1 g;  d_pose_i by back-substitution.

The JAX package shards the views over a mesh axis and reduces with
``psum``; here the sums run over the whole stack on one card, and a mesh
raises ``NotImplementedError`` (the multi-card form waits for the port of
``parallel/`` on ``torch.distributed``). The projection's 3x3 products are
written as sums (no TF32 can enter); the small solves are
``torch.linalg``'s.
"""

import numpy as np
import torch
from torch.func import jacfwd, vmap

from .._device import resolve_device
from ..geometry.distortion import distort_normalized
from ..geometry.rotations import rodrigues_to_matrix
from . import ba


def _project(obj, pose, intr, nd):
    """(N,3) obj -> (N,2) pixels; pose (6,), intr (4+nd,)."""
    R = rodrigues_to_matrix(pose[:3])
    p = [obj[:, 0] * R[j, 0] + obj[:, 1] * R[j, 1] + obj[:, 2] * R[j, 2]
         + pose[3 + j] for j in range(3)]
    xy = torch.stack([p[0] / p[2], p[1] / p[2]], 1)
    xyd = distort_normalized(xy, intr[4:4 + nd])
    u = intr[0] * xyd[:, 0] + intr[2]
    v = intr[1] * xyd[:, 1] + intr[3]
    return torch.stack([u, v], 1)


def _residual(obj, img, pose, intr, nd):
    return (_project(obj, pose, intr, nd) - img).reshape(-1)


def calibrate_camera_sharded(object_points, image_points, K_init,
                             dist_init, mesh=None, axis="views",
                             iterations=20, damping=1e-3, *,
                             device="cuda"):
    """Gauss-Newton camera calibration of many views on one card.

    object_points : (V, N, 3), image_points : (V, N, 2). K_init (3,3),
    dist_init (nd,) start values (use the host Zhang init on a subsample
    of views). ``mesh`` must be None: the multi-card form is not ported
    (``axis`` is kept for the JAX package's signature). Arrays run on
    ``device`` (default ``"cuda"``); the views are float32 there.

    Returns (rms, K, dist, poses (V, 6)), numpy float64 as the JAX
    package returns them.
    """
    if mesh is not None:
        raise NotImplementedError(
            "calibrate_camera_sharded: a mesh (views over several cards) "
            "is not ported; pass mesh=None to run on one card")
    dev = resolve_device(device)
    obj_np = np.asarray(object_points, np.float32)
    img_np = np.asarray(image_points, np.float32)
    nd = len(np.ravel(dist_init))
    n_intr = 4 + nd

    K_init = np.asarray(K_init, np.float64)
    intr = torch.as_tensor(np.concatenate([
        [K_init[0, 0], K_init[1, 1], K_init[0, 2], K_init[1, 2]],
        np.ravel(dist_init)]).astype(np.float32), device=dev)

    # per-view pose init on host (cheap, V homography DLTs)
    poses0 = []
    for o, i in zip(obj_np, img_np):
        H = ba._homography_dlt(o[:, :2], i)
        r, t = ba._extrinsics_from_h(H, K_init)
        poses0.append(np.concatenate([r, t]))
    poses = torch.as_tensor(np.stack(poses0).astype(np.float32), device=dev)
    obj = torch.as_tensor(obj_np, device=dev)
    img = torch.as_tensor(img_np, device=dev)

    eye6 = damping * torch.eye(6, dtype=torch.float32, device=dev)
    eye_i = damping * torch.eye(n_intr, dtype=torch.float32, device=dev)

    def one_view_blocks(intr, o, i, pose):
        r = _residual(o, i, pose, intr, nd)
        A = jacfwd(lambda th: _residual(o, i, pose, th, nd))(intr)
        B = jacfwd(lambda p: _residual(o, i, p, intr, nd))(pose)
        BtB_inv = torch.linalg.inv(B.T @ B + eye6)
        AtB = A.T @ B
        S = A.T @ A - AtB @ BtB_inv @ AtB.T
        g = A.T @ r - AtB @ (BtB_inv @ (B.T @ r))
        return S, g, B, BtB_inv, r

    def back(intr, d_intr, o, i, p, Bv, BtBi, rv):
        Av = jacfwd(lambda th: _residual(o, i, p, th, nd))(intr)
        rhs = Bv.T @ rv + (Av @ d_intr) @ Bv
        return p - BtBi @ rhs

    blocks = vmap(one_view_blocks, in_dims=(None, 0, 0, 0))
    backs = vmap(back, in_dims=(None, None, 0, 0, 0, 0, 0, 0))
    cost_of = vmap(lambda intr, o, i, p: (_residual(o, i, p, intr, nd)
                                          ** 2).sum(),
                   in_dims=(None, 0, 0, 0))

    for _ in range(iterations):
        S, g, B, BtB_inv, r = blocks(intr, obj, img, poses)
        d_intr = -torch.linalg.solve(S.sum(0) + eye_i, g.sum(0))
        poses = backs(intr, d_intr, obj, img, poses, B, BtB_inv, r)
        intr = intr + d_intr
    cost = cost_of(intr, obj, img, poses).sum().item()

    intr = intr.cpu().numpy().astype(np.float64)
    K = np.array([[intr[0], 0, intr[2]], [0, intr[1], intr[3]], [0, 0, 1]])
    rms = float(np.sqrt(cost / (obj_np.shape[0] * obj_np.shape[1])))
    return rms, K, intr[4:], poses.cpu().numpy()
