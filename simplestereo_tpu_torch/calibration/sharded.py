"""
sharded
=======

Device-resident Gauss-Newton camera calibration for large view counts, the
port of :mod:`simplestereo_tpu.calibration.sharded`, on one card or over a
mesh axis of :mod:`simplestereo_tpu_torch.parallel`.

Per-view Gauss-Newton blocks are built on the device with
``torch.func.jacfwd`` under ``torch.func.vmap`` and the intrinsic normal
equations are reduced over the views, the Schur-complement form:

    J_i = [A_i | B_i]   (A: d r_i / d intrinsics, B: d r_i / d pose_i)
    S   = sum_i A_i^T A_i - A_i^T B_i (B_i^T B_i)^-1 B_i^T A_i
    g   = sum_i A_i^T r_i - A_i^T B_i (B_i^T B_i)^-1 B_i^T r_i
    d_theta = -S^-1 g;  d_pose_i by back-substitution.

On one card the sums run over the whole stack. On a mesh, as in the JAX
package, the views are split over the mesh axis: each rank builds the
blocks of its own views, S, g and the cost are summed over the ranks
(``all_reduce`` SUM, the JAX ``psum``), every rank solves the same small
system, and pose blocks never leave their rank until the poses are
gathered at the end. The projection's 3x3 products are written as sums (no
TF32 can enter); the small solves are ``torch.linalg``'s.
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
    """Distributed Gauss-Newton camera calibration.

    object_points : (V, N, 3), image_points : (V, N, 2). K_init (3,3),
    dist_init (nd,) start values (use the host Zhang init on a subsample
    of views). ``mesh``: None runs every view on ``device`` (default
    ``"cuda"``); a :func:`..parallel.make_mesh` mesh splits the views over
    its axis ``axis`` (V divisible by its size) and runs on the mesh's
    device, every rank passing the same views. The views are float32.

    Returns (rms, K, dist, poses (V, 6)), numpy float64 as the JAX
    package returns them, on every rank.
    """
    obj_np = np.asarray(object_points, np.float32)
    img_np = np.asarray(image_points, np.float32)
    V = obj_np.shape[0]
    if mesh is None:
        dev, views = resolve_device(device), slice(None)
    else:
        from torch.distributed.device_mesh import DeviceMesh
        from .. import parallel
        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a DeviceMesh (parallel."
                            f"make_mesh), got {type(mesh).__name__}")
        dev = parallel.mesh_device(mesh)
        n, idx, _ = parallel._axis(mesh, axis)
        vl = parallel._split(n, V, axis, "views")
        views = slice(idx * vl, (idx + 1) * vl)
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
    poses = torch.as_tensor(np.stack(poses0).astype(np.float32)[views],
                            device=dev)
    obj = torch.as_tensor(obj_np[views], device=dev)
    img = torch.as_tensor(img_np[views], device=dev)

    def total(x):
        """The sum over every view: over the mesh's ranks too."""
        if mesh is not None:
            parallel.all_reduce(x, mesh, axis)
        return x

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
        d_intr = -torch.linalg.solve(total(S.sum(0)) + eye_i,
                                     total(g.sum(0)))
        poses = backs(intr, d_intr, obj, img, poses, B, BtB_inv, r)
        intr = intr + d_intr
    cost = total(cost_of(intr, obj, img, poses).sum()).item()
    if mesh is not None:
        poses = parallel.all_gather_cat(poses, mesh, axis)

    intr = intr.cpu().numpy().astype(np.float64)
    K = np.array([[intr[0], 0, intr[2]], [0, intr[1], intr[3]], [0, 0, 1]])
    rms = float(np.sqrt(cost / (obj_np.shape[0] * obj_np.shape[1])))
    return rms, K, intr[4:], poses.cpu().numpy()
