"""
chessboard
==========

Chessboard inner-corner detection without OpenCV, the port of
:mod:`simplestereo_tpu.calibration.chessboard` (``cv2.findChessboardCorners``
+ ``cv2.cornerSubPix``).

1. **Corner likelihood** (device): correlation with checkerboard corner
   prototypes (two orientations x two polarities, Geiger et al., ICRA
   2012) at two radii, as one ``F.conv2d`` with 8 output channels a
   radius, then elementwise min/max. TF32 is kept out of the convolution:
   cuDNN allows it for float32 convolutions by default, so the call runs
   under ``torch.backends.cudnn.flags(..., allow_tf32=False)``.
2. **Non-maximum suppression** (device): a separable (2*nms+1) max pool
   (two ``F.max_pool2d``, padded with -inf) and an equality test.
3. **Subpixel refinement** and 4. **lattice growth ordering** (host numpy
   float64 and scipy): copies of the JAX package's ``corner_subpix``,
   ``_grow_grid``, ``_orient_grid`` and the host part of
   ``find_chessboard_corners``, held to the originals by
   tests/test_torch_calibration.py.
"""

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device


# --------------------------------------------------------------------------
# device: corner likelihood + NMS
# --------------------------------------------------------------------------

def _prototype_kernels(radius, angle):
    """Four quadrant kernels (A, B opposite pair; C, D the other pair)."""
    r = radius
    ys, xs = np.mgrid[-r:r + 1, -r:r + 1]
    dist = np.sqrt(xs ** 2 + ys ** 2)
    w = np.exp(-(dist ** 2) / (2.0 * (r / 2.0) ** 2))
    n1 = np.array([np.cos(angle), np.sin(angle)])
    n2 = np.array([np.cos(angle + np.pi / 2), np.sin(angle + np.pi / 2)])
    s1 = xs * n1[0] + ys * n1[1]
    s2 = xs * n2[0] + ys * n2[1]
    A = w * ((s1 > 0.1) & (s2 > 0.1))
    B = w * ((s1 < -0.1) & (s2 < -0.1))
    C = w * ((s1 > 0.1) & (s2 < -0.1))
    D = w * ((s1 < -0.1) & (s2 > 0.1))
    out = []
    for k in (A, B, C, D):
        ssum = k.sum()
        out.append((k / ssum if ssum > 0 else k).astype(np.float32))
    return out


def _prototype_stack(radius):
    """(8, 1, 2r+1, 2r+1) float32: the 4 prototypes of angles 0 and pi/4,
    each flipped in both axes (the JAX package's convolution of the
    prototypes, as the cross-correlation that ``conv2d`` computes)."""
    kers = []
    for angle in (0.0, np.pi / 4):
        kers.extend(_prototype_kernels(radius, angle))
    return np.stack([k[::-1, ::-1] for k in kers])[:, None].copy()


def corner_response(gray, radii=(4, 8), nms_radius=4):
    """Checkerboard-corner likelihood map + NMS peak mask.

    gray : (H, W) float tensor in [0, 255], on the device that computes.
    Returns (response (H, W) float32, peaks (H, W) bool) tensors there.
    """
    img = gray.to(torch.float32)[None, None]
    resp = torch.zeros(gray.shape, dtype=torch.float32, device=gray.device)
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        for radius in radii:
            kk = torch.as_tensor(_prototype_stack(radius), device=gray.device)
            out = F.conv2d(img, kk, padding=radius)[0]
            for a in range(2):
                A, B, C, D = (out[4 * a + i] for i in range(4))
                mu = 0.25 * (A + B + C + D)
                r1 = torch.minimum(torch.minimum(A, B) - mu,
                                   mu - torch.maximum(C, D))
                r2 = torch.minimum(mu - torch.maximum(A, B),
                                   torch.minimum(C, D) - mu)
                resp = torch.maximum(resp, torch.maximum(r1, r2))

    k = 2 * nms_radius + 1
    # Separable max pool: (k, 1) then (1, k), -inf beyond the border.
    pooled = F.max_pool2d(resp[None, None], (k, 1), stride=1,
                          padding=(nms_radius, 0))
    pooled = F.max_pool2d(pooled, (1, k), stride=1,
                          padding=(0, nms_radius))[0, 0]
    peaks = (resp == pooled) & (resp > 0)
    return resp, peaks


# --------------------------------------------------------------------------
# host: subpixel refinement (cornerSubPix criterion)
# --------------------------------------------------------------------------

def corner_subpix(gray, corners, win_size=(11, 11), max_iter=100, eps=1e-6):
    """Gradient-criterion subpixel refinement (cv2.cornerSubPix parity).

    gray : (H, W) float; corners (N, 2) float (x, y). win_size is the
    half-size pair like OpenCV's (the full window is 2*win+1).
    """
    g = np.asarray(gray, np.float64)
    H, W = g.shape
    gx = np.zeros_like(g)
    gy = np.zeros_like(g)
    gx[:, 1:-1] = (g[:, 2:] - g[:, :-2]) * 0.5
    gy[1:-1, :] = (g[2:, :] - g[:-2, :]) * 0.5

    wx, wy = win_size
    ys, xs = np.mgrid[-wy:wy + 1, -wx:wx + 1]
    # cv2 uses a separable triangular-ish weight; gaussian works equally
    wmask = np.exp(-(xs ** 2 / (2.0 * (wx * 0.5) ** 2)
                     + ys ** 2 / (2.0 * (wy * 0.5) ** 2)))

    # All corners iterate together (their updates are independent, so
    # the vectorized trajectories equal the per-corner loop's); `active`
    # tracks the not-yet-converged set. This is a hot path: detection
    # refines every NMS candidate (hundreds) before lattice growth.
    q = np.asarray(corners, np.float64).copy()
    if not np.isfinite(q).all():
        raise ValueError("corners must be finite!")
    N = len(q)
    active = np.ones(N, bool)
    for _ in range(max_iter):
        idx = np.nonzero(active)[0]
        if len(idx) == 0:
            break
        ix = np.rint(q[idx, 0]).astype(np.int64)
        iy = np.rint(q[idx, 1]).astype(np.int64)
        inb = ((ix - wx - 1 >= 0) & (ix + wx + 1 < W)
               & (iy - wy - 1 >= 0) & (iy + wy + 1 < H))
        active[idx[~inb]] = False    # out of bounds: keep current q
        idx, ix, iy = idx[inb], ix[inb], iy[inb]
        if len(idx) == 0:
            break
        rows = iy[:, None, None] + ys
        cols = ix[:, None, None] + xs
        sgx = gx[rows, cols]
        sgy = gy[rows, cols]
        gxx = (wmask * sgx * sgx).sum(axis=(1, 2))
        gxy = (wmask * sgx * sgy).sum(axis=(1, 2))
        gyy = (wmask * sgy * sgy).sum(axis=(1, 2))
        px = xs + ix[:, None, None]
        py = ys + iy[:, None, None]
        bx = (wmask * (sgx * sgx * px + sgx * sgy * py)).sum(axis=(1, 2))
        by = (wmask * (sgx * sgy * px + sgy * sgy * py)).sum(axis=(1, 2))
        det = gxx * gyy - gxy * gxy
        ok = np.abs(det) >= 1e-12
        active[idx[~ok]] = False     # singular normal matrix: keep q
        det_safe = np.where(ok, det, 1.0)
        q_new = np.stack([(gyy * bx - gxy * by) / det_safe,
                          (gxx * by - gxy * bx) / det_safe], axis=1)
        moved = np.sqrt(((q_new - q[idx]) ** 2).sum(axis=1))
        q[idx[ok]] = q_new[ok]
        active[idx[ok & (moved < eps)]] = False
    return q


# --------------------------------------------------------------------------
# host: lattice growth ordering
# --------------------------------------------------------------------------

def _grow_grid(pts, seed, v1, v2, tol_rel=0.35):
    """BFS lattice assignment {(i, j) -> point index} from a seed corner."""
    from scipy.spatial import cKDTree

    tree = cKDTree(pts)
    grid = {(0, 0): seed}
    used = {seed}
    frontier = [(0, 0)]
    base = {(0, 0): (v1, v2)}

    def predict(ij, dij):
        """Second-order extrapolation if two collinear cells exist."""
        i, j = ij
        di, dj = dij
        p1 = grid.get((i - di, j - dj))
        p2 = grid.get((i - 2 * di, j - 2 * dj))
        if p1 is not None and p2 is not None:
            return 2 * pts[p1] - pts[p2]
        if p1 is not None:
            vv1, vv2 = base[(i - di, j - dj)]
            return pts[p1] + di * vv1 + dj * vv2
        return None

    while frontier:
        ij = frontier.pop(0)
        i, j = ij
        v1c, v2c = base[ij]
        step = 0.5 * (np.linalg.norm(v1c) + np.linalg.norm(v2c))
        for dij in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            nij = (i + dij[0], j + dij[1])
            if nij in grid:
                continue
            pred = predict(nij, dij)
            if pred is None:
                pred = pts[grid[ij]] + dij[0] * v1c + dij[1] * v2c
            dist, idx = tree.query(pred)
            if dist < tol_rel * step and idx not in used:
                grid[nij] = idx
                used.add(idx)
                # local basis at the new cell
                nv1 = (pts[idx] - pts[grid[ij]]) if dij[0] else v1c
                if dij[0] < 0:
                    nv1 = -nv1
                nv2 = (pts[idx] - pts[grid[ij]]) if dij[1] else v2c
                if dij[1] < 0:
                    nv2 = -nv2
                base[nij] = (nv1 if dij[0] else v1c,
                             nv2 if dij[1] else v2c)
                frontier.append(nij)
    return grid


def _orient_grid(grid, pts, rows, cols):
    """Extract a full rows x cols block and normalize its orientation.

    Ordering convention (deterministic and identical for the two views of
    a stereo pair): row-major with the +col direction positive along its
    dominant image axis, and the row direction chosen so the (col, row)
    basis is right-handed in image coordinates.
    """
    keys = np.asarray(list(grid))
    imin, jmin = keys.min(axis=0)
    imax, jmax = keys.max(axis=0)
    span = (imax - imin + 1, jmax - jmin + 1)
    full = np.full(span, -1, int)
    for (i, j), idx in grid.items():
        full[i - imin, j - jmin] = idx
    # The grown lattice may have absorbed a few spurious detections beyond
    # the physical board; search for a completely-filled rows x cols (or
    # transposed) sub-block.
    M = None
    for a, b, transpose in ((rows, cols, False), (cols, rows, True)):
        if span[0] < a or span[1] < b:
            continue
        for i0 in range(span[0] - a + 1):
            for j0 in range(span[1] - b + 1):
                sub = full[i0:i0 + a, j0:j0 + b]
                if (sub >= 0).all():
                    M = sub.T if transpose else sub
                    break
            if M is not None:
                break
        if M is not None:
            break
    if M is None:
        return None
    v_col = pts[M[0, -1]] - pts[M[0, 0]]
    if abs(v_col[0]) >= abs(v_col[1]):
        if v_col[0] < 0:
            M = M[:, ::-1]
    elif v_col[1] < 0:
        M = M[:, ::-1]
    v_col = pts[M[0, -1]] - pts[M[0, 0]]
    v_row = pts[M[-1, 0]] - pts[M[0, 0]]
    if v_col[0] * v_row[1] - v_col[1] * v_row[0] < 0:
        M = M[::-1]
    return M


def find_chessboard_corners(gray, pattern_size, response_quantile=0.97,
                            max_candidates=600, max_seeds=20, *,
                            device="cuda"):
    """Detect and order the inner corners of a chessboard.

    Parameters
    ----------
    gray : (H, W) image (uint8 or float).
    pattern_size : (cols, rows) inner-corner counts, OpenCV convention
        (the reference passes (7, 6), calibration.py:60-61).
    device : where the corner likelihood of a non-tensor image is
        computed (default ``"cuda"``); a tensor computes on its device.
        Refinement and ordering run on the host.

    Returns
    -------
    (found, corners) — corners (rows*cols, 2) float64 (x, y) subpixel
    positions in row-major order, or (False, None).
    """
    cols, rows = pattern_size
    n_target = rows * cols
    g = (gray.detach().cpu().numpy() if isinstance(gray, torch.Tensor)
         else np.asarray(gray)).astype(np.float64)
    if g.ndim == 3:
        g = g.mean(axis=2)

    dev = (gray.device if isinstance(gray, torch.Tensor)
           else resolve_device(device))
    resp, peaks = corner_response(
        torch.as_tensor(g.astype(np.float32), device=dev))
    resp = resp.cpu().numpy()
    peaks = peaks.cpu().numpy()
    ys, xs = np.nonzero(peaks)
    if len(ys) < n_target:
        return False, None
    vals = resp[ys, xs]
    # adaptive threshold: keep clearly-above-noise candidates
    thr = max(np.quantile(vals, response_quantile) * 0.2, vals.max() * 0.05)
    keep = vals > thr
    ys, xs, vals = ys[keep], xs[keep], vals[keep]
    if len(ys) > max_candidates:
        top = np.argsort(vals)[-max_candidates:]
        ys, xs, vals = ys[top], xs[top], vals[top]
    if len(ys) < n_target:
        return False, None

    pts = corner_subpix(g, np.stack([xs, ys], 1).astype(np.float64),
                        win_size=(5, 5))

    from scipy.spatial import cKDTree
    tree = cKDTree(pts)
    order = np.argsort(vals)[::-1]
    for seed in order[:max_seeds]:
        k = min(9, len(pts))
        dists, idxs = tree.query(pts[seed], k=k)
        best = None
        for a in range(1, k):
            for b in range(a + 1, k):
                va = pts[idxs[a]] - pts[seed]
                vb = pts[idxs[b]] - pts[seed]
                la, lb = np.linalg.norm(va), np.linalg.norm(vb)
                if la < 1e-6 or lb < 1e-6:
                    continue
                cosang = abs(va @ vb) / (la * lb)
                ratio = max(la, lb) / min(la, lb)
                if cosang < 0.45 and ratio < 1.6:
                    score = cosang + ratio
                    if best is None or score < best[0]:
                        best = (score, va, vb)
        if best is None:
            continue
        _, v1, v2 = best
        grid = _grow_grid(pts, seed, v1, v2)
        if len(grid) < n_target:
            continue
        M = _orient_grid(grid, pts, rows, cols)
        if M is None:
            continue
        ordered = pts[M.ravel()]
        # Final high-accuracy refinement. The reference always uses an
        # 11x11 half-window (calibration.py:21); that window must not span
        # neighboring squares, so adapt it to the measured lattice step.
        step = np.median(np.linalg.norm(
            ordered[1:] - ordered[:-1], axis=1))
        win = int(np.clip(step * 0.4, 2, 11))
        ordered = corner_subpix(g, ordered, win_size=(win, win))
        return True, ordered
    return False, None
