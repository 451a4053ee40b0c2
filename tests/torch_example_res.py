"""A stand-in for the reference's ``examples/res`` tree, built from a seed,
for the example scripts of both packages (``tests/test_torch_examples_*.py``
on the CPU, ``chip_smoke.py`` phase 30 on the card), and the renderers
``chip_smoke.py``'s phases 16 and 23 draw their scenes with.

:func:`build_res` writes the layout the scripts read::

    1/calib/{i}_L.png, {i}_R.png   10 chessboard pairs (7x6 inner corners,
                                   squares of 60.5 units, the scripts'
                                   squareSize) seen through the seeded rig
    1/rig.json                     that rig
    1/left.png, right.png          a noise-covered plane seen through it
    2/rig.json                     the same rig
    2/rigRect.json                 the port's directRectify of it
    2/lawn_L.png, lawn_R.png       a noise-covered plane whose rectified
                                   disparity is constant (PLANE_DISP at
                                   1280 columns, scaled with the width;
                                   texels of LAWN_TEXEL px)
    tsukuba/tsukuba_l.png, _r.png  fronto-parallel textured layers at
                                   integer disparities 5..14, rendered
                                   left to right with their occlusions
    tsukuba/groundtruth.png        the left view's disparity x 16
    tsukuba/nonocc.png             255 where a left pixel is seen in both
    stereoFTP/stereoRig.json       camera and projector (no distortion:
                                   103 synthesizes its capture through the
                                   intrinsics alone)
    stereoFTP/fringe8.png          buildFringe(8, red stripe) at the
                                   projector's size

There is no ``stereoFTP/ellipsoid8.png``, so both 103 scripts take their
own synthesis branch. ``SIZES`` gives the two sizes: ``"full"`` is the
reference's (1280x720 for the rigs and the lawn pair, 384x288 for
Tsukuba), ``"small"`` a scaled copy of the same scenes for the CPU tests
(320x180; Tsukuba 128x144, whose 144 rows leave 18 a tile on 8 devices,
above the 17-row halo of example 201's ASW).

:func:`run_script` runs one of the port's scripts on such a tree,
:func:`run_jax_script` the JAX package's (its text unedited but for the
path literal of the reference's resources), and the helpers below them
compare what two runs wrote and printed, with the tolerances the tests
and phase 30 state.

numpy, zlib (through the port's PNG writer) and the port only: the
card's machine has neither JAX nor Pillow.
"""

import contextlib
import io
import os
import re
import sys

import numpy as np
import torch

from simplestereo_tpu_torch.examples import _cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The path both packages' scripts read the reference's resources from.
SCRIPT_RES = _cli.REFERENCE_RES

SEED = 0
RIG_SEED = 40

# (w, h) of res/1 (the chessboards, and the scene of 004a and 004b), of
# res/2 (the lawn pair), of Tsukuba and of the camera-projector rig.
# Chessboards need the reference's 1280x720 in both: at 320x180 the
# recovered rotation is 0.011 off, at 640x360 the translation 0.72 units,
# beyond tests/test_calibration.py's 2e-3 and 0.5.
SIZES = {"full": {"1": (1280, 720), "2": (1280, 720),
                  "tsukuba": (384, 288), "stereoFTP": (1280, 720)},
         "small": {"1": (1280, 720), "2": (320, 180),
                   "tsukuba": (128, 144), "stereoFTP": (320, 180)}}

# res/2's plane: its rectified disparity at 1280 columns (inside 1..90 of
# example 009 and 1..96 of 008 and 011, at every DOWN they are run with);
# res/1's scene plane.
PLANE_DISP = 45.0
SCENE_DISP = 30.0
# px per texel of the lawn's noise: 4 in the small pair, so that examples
# 008 and 009 at DOWN 2 see 2-px texels, as the full pair does at DOWN 1
# (009's step-2 window aliases on 1-px texels).
LAWN_TEXEL = {"full": 2.0, "small": 4.0}

# Chessboards: inner corners, views, supersampling, pose seed; squares of
# CAL_SQ units unless stated (the scripts pass 60.5).
CAL_CB = (7, 6)
CAL_SQ = 40.0
CAL_VIEWS = 10
CAL_SCALE = 3
CAL_SEED = 23
EXAMPLE_SQ = 60.5

# Tsukuba stand-in: the background's disparity, then each layer's
# (disparity, x0, x1, y0, y1) as shares of the width and height, far to
# near.
TSUKUBA_BG = 5
TSUKUBA_LAYERS = ((8, 0.10, 0.45, 0.15, 0.55), (11, 0.55, 0.85, 0.10, 0.50),
                  (12, 0.40, 0.75, 0.55, 0.90), (14, 0.15, 0.35, 0.60, 0.85))
TSUKUBA_RANGE = (5, 14)

# Camera-projector rig of stereoFTP: chip_smoke.py's scan rig (focal 1400
# at 1280 columns) with its baseline scaled to example 103's plane at
# z0 = 1500, so the fringe lights the same projector columns.
FTP_Z0 = 1500.0
FTP_PERIOD = 8
FTP_R = (0.0, -0.05, 0.0)
FTP_T = (-115.4, 2.885, 17.31)


def random_rig_args(seed=RIG_SEED, res=(1280, 720)):
    """A random rig: modest rotation, mostly-x baseline, distinct
    intrinsics, small distortion on both cameras. Drawn at 1280x720; at
    another ``res`` the intrinsics are scaled by its width over 1280."""
    from simplestereo_tpu_torch.geometry import npgeom
    rng = np.random.default_rng(seed)
    f1 = rng.uniform(700, 1500)
    f2 = f1 * rng.uniform(0.9, 1.1)
    K1 = np.array([[f1, 0, rng.uniform(600, 680)],
                   [0, f1 * rng.uniform(0.98, 1.02), rng.uniform(330, 390)],
                   [0, 0, 1.0]])
    K2 = np.array([[f2, 0, rng.uniform(600, 680)],
                   [0, f2 * rng.uniform(0.98, 1.02), rng.uniform(330, 390)],
                   [0, 0, 1.0]])
    R = npgeom.rodrigues_to_matrix(rng.normal(0, 0.06, 3))
    T = np.array([[-rng.uniform(60, 220)],
                  [rng.normal(0, 5)], [rng.normal(0, 8)]])
    d1 = np.r_[rng.normal(0, 0.05, 2), rng.normal(0, 0.002, 2), 0.0]
    d2 = np.r_[rng.normal(0, 0.05, 2), rng.normal(0, 0.002, 2), 0.0]
    if tuple(res) != (1280, 720):
        s = np.diag([res[0] / 1280, res[0] / 1280, 1.0])
        K1, K2 = s @ K1, s @ K2
    return tuple(res), tuple(res), K1, K2, d1, d2, R, T


def disparity_plane(rect, target):
    """(n, c, p0): the plane n . X = c (camera-1 frame, |n| = 1) whose
    rectified disparity is ``target`` at every pixel, and a point p0 on it.
    The rectified views share their rows, so the points of one disparity
    form a plane (with the two views' different x-shears it is not
    fronto-parallel); three of them, triangulated through the rectified
    projection matrices, fix it."""
    P1, P2 = rect.getRectifiedProjectionMatrices()
    w, h = rect.res1
    pts = []
    for u, v in ((0.25 * w, 0.25 * h), (0.75 * w, 0.25 * h),
                 (0.5 * w, 0.75 * h)):
        A = np.stack([u * P1[2] - P1[0], v * P1[2] - P1[1],
                      (u - target) * P2[2] - P2[0], v * P2[2] - P2[1]])
        X = np.linalg.svd(A)[2][-1]
        pts.append(X[:3] / X[3])
    n = np.cross(pts[1] - pts[0], pts[2] - pts[0])
    n /= np.linalg.norm(n)
    return n, float(n @ pts[0]), pts[0]


def render_plane(rig, plane, shape, seed=SEED, texel_px=2.0):
    """The two distorted views of ``plane`` (from :func:`disparity_plane`)
    covered in noise, about ``texel_px`` px per texel, uint8 BGR: each
    pixel's ray is undistorted, meets the plane, and the texture is
    sampled bilinearly there in the plane's own coordinates."""
    from simplestereo_tpu_torch.geometry import npgeom
    n, c, p0 = plane
    h, w = shape
    n_tex = int(w / texel_px) + 200
    tex = np.random.default_rng(seed).integers(
        0, 256, (n_tex, n_tex, 3)).astype(np.float64)
    texel = texel_px * p0[2] / rig.intrinsic1[0, 0]
    e1 = np.cross([0.0, 1.0, 0.0], n)
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(n, e1)
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    pix = np.stack([u, v], -1).reshape(-1, 2)
    R, T = rig.R, rig.T.ravel()
    views = []
    for K, d, Rw, C in ((rig.intrinsic1, rig.distCoeffs1, np.eye(3),
                         np.zeros(3)),
                        (rig.intrinsic2, rig.distCoeffs2, R, -R.T @ T)):
        ray = np.concatenate([npgeom.undistort_points(pix, K, d),
                              np.ones((len(pix), 1))], 1) @ Rw
        P = C + ray * ((c - n @ C) / (ray @ n))[:, None]
        tx = (P - p0) @ e1 / texel + n_tex / 2
        ty = (P - p0) @ e2 / texel + n_tex / 2
        x0 = np.clip(np.floor(tx).astype(int), 0, n_tex - 2)
        y0 = np.clip(np.floor(ty).astype(int), 0, n_tex - 2)
        fx, fy = (tx - x0)[:, None], (ty - y0)[:, None]
        val = ((tex[y0, x0] * (1 - fx) + tex[y0, x0 + 1] * fx) * (1 - fy)
               + (tex[y0 + 1, x0] * (1 - fx) + tex[y0 + 1, x0 + 1] * fx) * fy)
        views.append(np.clip(np.round(val), 0, 255).astype(np.uint8)
                     .reshape(h, w, 3))
    return views


def true_disparity(rect, plane, shape):
    """The plane's rectified disparity at every rectified left pixel: the
    pixel's ray through P1 meets the plane, P2 projects the point."""
    n, c, _ = plane
    h, w = shape
    P1, P2 = rect.getRectifiedProjectionMatrices()
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    ray = np.stack([u, v, np.ones_like(u)], -1) @ np.linalg.inv(P1[:, :3]).T
    X = ray * (c / (ray @ n))[..., None]
    x2 = np.concatenate([X, np.ones_like(u)[..., None]], -1) @ P2.T
    return u - x2[..., 0] / x2[..., 2]


def plane_interior(rect, pad, max_disp):
    """Rectified left pixels where both views see the scene, eroded by a
    window's half width ``pad``, and past the first ``max_disp + pad``
    columns (where a candidate could leave the image)."""
    from scipy.ndimage import binary_erosion
    w, h = rect.res1

    def inside(mx, my):
        mx, my = mx.cpu().numpy(), my.cpu().numpy()
        return (mx >= 0) & (mx <= w - 1) & (my >= 0) & (my <= h - 1)

    valid = inside(rect.mapx1, rect.mapy1) & inside(rect.mapx2, rect.mapy2)
    valid = binary_erosion(valid, np.ones((2 * pad + 1, 2 * pad + 1)))
    valid[:, :max_disp + pad] = False
    return valid


# Rows a CPU pass of the chessboard renderers works on at a time: the
# same elementwise values as one pass over the whole 1280x720 x 9
# supersampled arrays, about 6x sooner, as the chunks stay in cache.
CPU_CHUNK = 1 << 16


def _chunks(x):
    """``x`` split along its first axis into CPU_CHUNK rows on the CPU;
    whole elsewhere."""
    return x.split(CPU_CHUNK) if x.device.type == "cpu" else (x,)


def calib_rays(K, dist, res, dev):
    """(N, 3) float64 rays (z = 1), on ``dev``, of every supersampled pixel
    of a distorted camera: subpixel i at pixel (i + 0.5) / scale - 0.5."""
    from simplestereo_tpu_torch.geometry import undistort_points
    w, h = res
    s = CAL_SCALE
    xs = (torch.arange(w * s, dtype=torch.float64, device=dev) + 0.5) / s - 0.5
    ys = (torch.arange(h * s, dtype=torch.float64, device=dev) + 0.5) / s - 0.5
    v, u = torch.meshgrid(ys, xs, indexing="ij")
    xy = torch.cat([undistort_points(p, K, dist) for p in _chunks(
        torch.stack([u, v], -1).reshape(-1, 2))])
    return torch.cat([xy, torch.ones_like(xy[:, :1])], 1)


def render_board(rays, Rb, tb, res, square=CAL_SQ):
    """The board (pose Rb, tb in the camera's frame) seen along ``rays``:
    each ray meets its plane, the board's (x, y) there picks a dark or a
    light square (20 or 235; light outside the board), and each pixel is
    the mean of its subpixels, truncated to uint8."""
    Rb = torch.as_tensor(Rb, device=rays.device)
    tb = torch.as_tensor(tb, device=rays.device)
    n = Rb[:, 2]
    cols, rows = CAL_CB

    def shade(r):
        s = (n * tb).sum() / (r * n).sum(1)
        X = s[:, None] * r - tb
        bx = (X * Rb[:, 0]).sum(1)
        by = (X * Rb[:, 1]).sum(1)
        inside = ((bx > -square) & (bx < cols * square) & (by > -square)
                  & (by < rows * square) & (s > 0))
        dark = inside & ((torch.floor(bx / square) + torch.floor(by / square))
                         % 2 == 0)
        return torch.where(dark, 20.0, 235.0)

    img = torch.cat([shade(r) for r in _chunks(rays)]).to(torch.float64)
    w, h = res
    img = img.reshape(h, CAL_SCALE, w, CAL_SCALE).mean((1, 3))
    return img.to(torch.uint8).cpu().numpy()


def calib_poses(rig_args, square=CAL_SQ):
    """CAL_VIEWS board poses (R, t) in camera 1's frame whose whole board
    (with its outer squares) projects inside both distorted views with a
    margin of 30 px at 1280 columns (the margin scales with the width),
    700-1300 units away."""
    from simplestereo_tpu_torch.calibration import ba
    res1, res2, K1, K2, d1, d2, R, T = rig_args
    T = T.ravel()
    cols, rows = CAL_CB
    margin = 30 * res1[0] / 1280
    c = np.array([[-square, -square, 0], [cols * square, -square, 0],
                  [-square, rows * square, 0],
                  [cols * square, rows * square, 0]])

    def inside(K, d, Rc, tc, res):
        uv = ba.project_points(c, ba._rodrigues_inv(Rc), tc, K[0, 0],
                               K[1, 1], K[0, 2], K[1, 2], d)
        return (uv.min() > margin and uv[:, 0].max() < res[0] - margin
                and uv[:, 1].max() < res[1] - margin)

    rng = np.random.default_rng(CAL_SEED)
    mid = -R.T @ T / 2  # halfway between the two centres
    poses = []
    while len(poses) < CAL_VIEWS:
        Rb = ba._rodrigues(rng.normal(0, 0.35, 3))
        z = rng.uniform(700, 1300)
        tb = np.array([mid[0] - (cols - 1) * square / 2 + rng.normal(0, 60),
                       -(rows - 1) * square / 2 + rng.normal(0, 50), z])
        if inside(K1, d1, Rb, tb, res1) and inside(K2, d2, R @ Rb,
                                                   R @ tb + T, res2):
            poses.append((Rb, tb))
    return poses


def render_boards(rig_args, square, dev):
    """CAL_VIEWS (left, right) uint8 gray chessboard pairs of ``rig_args``
    rendered on ``dev``, each board at a pose of :func:`calib_poses`."""
    res1, res2, K1, K2, d1, d2, R, T = rig_args
    poses = calib_poses(rig_args, square)
    rays1 = calib_rays(K1, d1, res1, dev)
    rays2 = calib_rays(K2, d2, res2, dev)
    return [(render_board(rays1, Rb, tb, res1, square),
             render_board(rays2, R @ Rb, R @ tb + T.ravel(), res2, square))
            for Rb, tb in poses]


def tsukuba_scene(size, seed=SEED):
    """(left, right, gt, nonocc) of TSUKUBA_LAYERS at ``size`` (w, h):
    uint8 BGR views, the left view's integer disparity (uint8) and the
    bool mask of left pixels seen in the right view. Each layer carries
    its own band-limited noise, fixed in the left view's coordinates; a
    right pixel x sees, of the layers that cover x + d in the left view,
    the nearest."""
    w, h = size
    rng = np.random.default_rng(seed)
    layers = [(TSUKUBA_BG, 0, w, 0, h)] + [
        (d, round(x0 * w), round(x1 * w), round(y0 * h), round(y1 * h))
        for d, x0, x1, y0, y1 in TSUKUBA_LAYERS]
    pad = TSUKUBA_RANGE[1] + 2
    texs = []
    for _ in layers:
        t = rng.integers(0, 256, (h + 2, w + pad + 2, 3)).astype(np.float64)
        # 3x3 box blur: about 2 px per texel, as render_plane's noise
        t = sum(t[i:i + h, j:j + w + pad] for i in range(3)
                for j in range(3)) / 9
        texs.append(np.round(t).astype(np.uint8))
    ys, xs = np.mgrid[0:h, 0:w]

    def cover(i, x):
        _, x0, x1, y0, y1 = layers[i]
        return (x >= x0) & (x < x1) & (ys >= y0) & (ys < y1)

    top_l = np.zeros((h, w), int)
    top_r = np.zeros((h, w), int)
    for i, (d, *_) in enumerate(layers):  # far to near: the last wins
        top_l[cover(i, xs)] = i
        top_r[cover(i, xs + d)] = i
    disp = np.array([layer[0] for layer in layers])
    dl, dr = disp[top_l], disp[top_r]
    stack = np.stack(texs)
    left = stack[top_l, ys, xs]
    right = stack[top_r, ys, xs + dr]
    xr = xs - dl
    seen = xr >= 0
    nonocc = seen & (top_r[ys, np.clip(xr, 0, w - 1)] == top_l)
    return left, right, dl.astype(np.uint8), nonocc


def ftp_rig_args(size):
    """The camera-projector rig of stereoFTP at ``size`` (w, h): both
    focal 1400 at 1280 columns, principal points at the centre, no
    distortion."""
    from simplestereo_tpu_torch.geometry import npgeom
    w, h = size
    f = 1400.0 * w / 1280
    K = np.array([[f, 0, (w - 1) / 2], [0, f, (h - 1) / 2], [0, 0, 1.0]])
    return (size, size, K, K.copy(), np.zeros(5), np.zeros(5),
            npgeom.rodrigues_to_matrix(np.array(FTP_R)),
            np.array(FTP_T)[:, None])


def build_res(root, size="small", seed=SEED, device="cpu",
              parts=("1", "2", "tsukuba", "stereoFTP")):
    """Write the stand-in ``res`` tree under ``root`` (see the module's
    docstring) at ``size`` ("full" or "small"), the folders named in
    ``parts`` only; the chessboards render on ``device``. Returns, for
    each folder written, the truths its scripts are held to."""
    import simplestereo_tpu_torch as ss
    from simplestereo_tpu_torch.imgio import imwrite
    sz = SIZES[size]
    truth = {}

    def path(*names):
        p = os.path.join(root, *names)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        return p

    def rig_of(part):
        args = random_rig_args(RIG_SEED, sz[part])
        rig = ss.StereoRig(*args, device="cpu")
        return args, rig, ss.rectification.directRectify(rig)

    if "1" in parts:  # chessboards, the rig, a scene through it
        args, rig, rect = rig_of("1")
        for i, (l, r) in enumerate(render_boards(args, EXAMPLE_SQ, device)):
            imwrite(path("1", "calib", f"{i}_L.png"), l)
            imwrite(path("1", "calib", f"{i}_R.png"), r)
        rig.save(path("1", "rig.json"))
        w, h = sz["1"]
        scene = disparity_plane(rect, SCENE_DISP * w / 1280)
        left, right = render_plane(rect, scene, (h, w), seed + 1)
        imwrite(path("1", "left.png"), left)
        imwrite(path("1", "right.png"), right)
        truth["1"] = dict(rig_args=args)
    if "2" in parts:  # the rig, its rectification, the lawn plane
        args, rig, rect = rig_of("2")
        rig.save(path("2", "rig.json"))
        rect.save(path("2", "rigRect.json"))
        w, h = sz["2"]
        disp = PLANE_DISP * w / 1280
        lawn = disparity_plane(rect, disp)
        left, right = render_plane(rect, lawn, (h, w), seed,
                                   LAWN_TEXEL[size])
        imwrite(path("2", "lawn_L.png"), left)
        imwrite(path("2", "lawn_R.png"), right)
        truth["2"] = dict(rig_args=args, rect=rect, plane=lawn, disp=disp)
    if "tsukuba" in parts:
        left, right, gt, nonocc = tsukuba_scene(sz["tsukuba"], seed)
        imwrite(path("tsukuba", "tsukuba_l.png"), left)
        imwrite(path("tsukuba", "tsukuba_r.png"), right)
        imwrite(path("tsukuba", "groundtruth.png"), gt * 16)
        imwrite(path("tsukuba", "nonocc.png"), nonocc.astype(np.uint8) * 255)
        truth["tsukuba"] = dict(left=left, right=right, gt=gt, nonocc=nonocc)
    if "stereoFTP" in parts:
        args = ftp_rig_args(sz["stereoFTP"])
        ss.StereoRig(*args, device="cpu").save(
            path("stereoFTP", "stereoRig.json"))
        imwrite(path("stereoFTP", "fringe8.png"), ss.active.buildFringe(
            FTP_PERIOD, dims=sz["stereoFTP"], stripeColor="red"))
        truth["stereoFTP"] = dict(rig_args=args, z0=FTP_Z0)
    return truth


def tree_fixture(*parts):
    """A module-scoped, autouse pytest fixture ``tree``: (root, truth) of
    the small tree's folders ``parts`` under a temporary root. The
    module's tests run with one torch thread: tier-1 runs six workers
    beside each other, where intra-op threads only contend (example 009
    took 640 s under the whole run with eight, 13 s alone)."""
    import pytest

    @pytest.fixture(scope="module", autouse=True)
    def tree(tmp_path_factory):
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            root = tmp_path_factory.mktemp("res")
            yield root, build_res(root, "small", parts=parts)
        finally:
            torch.set_num_threads(threads)
    return tree


def _exec(path, src, cwd, argv):
    """Run ``src`` (the script at ``path``) as ``__main__`` in ``cwd`` with
    ``argv``; return what it printed."""
    out = io.StringIO()
    old = sys.argv, os.getcwd()
    sys.argv = [path, *map(str, argv)]
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(out):
            exec(compile(src, path, "exec"),
                 {"__name__": "__main__", "__file__": path})
    finally:
        sys.argv = old[0]
        os.chdir(old[1])
    return out.getvalue()


def run_script(name, res, cwd, argv=(), device=None):
    """Run the port's example ``name`` in ``cwd`` with its resources at
    ``res`` (``_cli.REFERENCE_RES`` pointed there for the run) and
    ``--device device`` (``None``: the script's default, the card).
    Returns what it printed."""
    path = os.path.join(REPO, "simplestereo_tpu_torch", "examples", name)
    with open(path) as f:
        src = f.read()
    old = _cli.REFERENCE_RES
    _cli.REFERENCE_RES = str(res)
    try:
        return _exec(path, src, cwd, [*argv, *(
            () if device is None else ("--device", device))])
    finally:
        _cli.REFERENCE_RES = old


def run_jax_script(name, res, cwd, argv=()):
    """Run the JAX package's example ``name`` in ``cwd``, its text as it
    is but for the resources' path literal, which becomes ``res``.
    Returns what it printed."""
    path = os.path.join(REPO, "examples", name)
    with open(path) as f:
        src = f.read()
    return _exec(path, src.replace(SCRIPT_RES, str(res)), cwd, argv)


def run_both(name, res, tmp_path, argv=()):
    """Run the JAX package's script ``name`` and the port's (on the CPU),
    each in a folder of its own under ``tmp_path`` (a pathlib.Path).
    Returns ((folder, printed) of the JAX run, of the port's)."""
    out = []
    for side in ("jax", "port"):
        cwd = tmp_path / side
        cwd.mkdir()
        out.append((cwd, run_jax_script(name, res, cwd, argv)
                    if side == "jax" else
                    run_script(name, res, cwd, argv, device="cpu")))
    return out


def record(monkeypatch, owner, name):
    """Keep, in the list returned, (arguments, result) of every call of
    ``owner.name`` (a function or a method) for the rest of the test."""
    real = getattr(owner, name)
    seen = []

    def spy(*args, **kwargs):
        out = real(*args, **kwargs)
        seen.append((args, kwargs, out))
        return out

    monkeypatch.setattr(owner, name, spy)
    return seen


# Tolerances, what two runs of one script (the JAX package's and the
# port's, or the port's on the card and on the CPU) may differ by:
JSON_RTOL = 1e-9       # rig and rectified-rig JSON, printed matrices
UINT8_SHARE = 1e-3     # uint8 images out of a remap: |d| <= 1 on this share
MAP_SHARE = 0.01       # disparity maps and their PNGs (near-ties)
PLY_RTOL = 1e-5        # PLY points, with the same point count
WLS_TOL = 2e-3         # WLS fills on a noise guide, of the output's scale
WLS_PLY_RTOL = 1e-3    # PLY points of two WLS outputs within WLS_TOL
BAD2_POINTS = 0.5      # printed bad-2.0 and density, percentage points
ERR_PX = 0.05          # printed avgerr and rms, px
CLOUD_ATOL = 1e-2      # example 103's cloud, units
PLANE_BAR = 0.90       # share of the lawn's interior within 1 px


NUMBER = re.compile(r"[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?")


def numbers(text):
    """Every number printed in ``text``, in order, as float64."""
    return np.array([float(x) for x in NUMBER.findall(text)])


def numbers_close(a, b, rtol=JSON_RTOL):
    """Two printouts with the same count of numbers, each within
    ``rtol``. Returns the numbers of ``a``."""
    x, y = numbers(a), numbers(b)
    assert x.shape == y.shape and x.size, (a, b)
    np.testing.assert_allclose(y, x, rtol=rtol, atol=1e-300)
    return x


def json_close(a, b, rtol=JSON_RTOL):
    """Two JSON files with the same keys, every number within ``rtol``
    of the larger magnitude of its array. Returns the largest relative
    difference."""
    import json
    with open(a) as f:
        ja = json.load(f)
    with open(b) as f:
        jb = json.load(f)
    assert ja.keys() == jb.keys(), (ja.keys(), jb.keys())
    worst = 0.0
    for k in ja:
        x, y = np.asarray(ja[k], np.float64), np.asarray(jb[k], np.float64)
        assert x.shape == y.shape, (k, x.shape, y.shape)
        scale = max(np.abs(x).max(initial=0), np.abs(y).max(initial=0), 1e-300)
        err = float(np.abs(x - y).max(initial=0) / scale)
        assert err <= rtol, f"{k}: relative difference {err:.3g}"
        worst = max(worst, err)
    return worst


def uint8_close(a, b, share=UINT8_SHARE, where="uint8 images"):
    """Two uint8 images of one shape, pixels at most 1 apart on at most
    ``share`` of them (``where`` names them in a failure). Returns the
    share that differs."""
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8, \
        (where, a.shape, a.dtype, b.shape, b.dtype)
    d = np.abs(a.astype(np.int64) - b.astype(np.int64))
    got = float((d > 0).mean())
    assert d.max() <= 1 and got <= share, \
        f"{where}: max diff {d.max()}, {got:.4%} of pixels differ"
    return got


def maps_close(a, b, share=MAP_SHARE):
    """Two maps (disparity, or their PNGs) of one shape and type that
    differ on at most ``share`` of their pixels. Returns that share."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, \
        (a.shape, a.dtype, b.shape, b.dtype)
    got = float((a != b).mean())
    assert got <= share, f"{got:.4%} of pixels differ"
    return got


def ply_layout(path):
    """(header lines, vertices, columns) of a PLY file."""
    from simplestereo_tpu_torch import points
    return points._ply_layout(str(path))


def _ply_pair(a, b):
    """The vertex rows of two PLY files with the same vertex count and
    columns, and how far each point of one is from the other's, relative
    to its distance from the origin."""
    from simplestereo_tpu_torch import points
    na, nb = ply_layout(a), ply_layout(b)
    assert na == nb, (na, nb)
    cols = range(na[2])
    pa, pb = points.importPLY(str(a), *cols), points.importPLY(str(b), *cols)
    scale = np.maximum(np.linalg.norm(pa[:, :3], axis=1), 1e-12)
    return pa, pb, np.abs(pa[:, :3] - pb[:, :3]).max(1) / scale


def ply_close(a, b, rtol=PLY_RTOL):
    """Two PLY files with the same vertex count and columns, points within
    ``rtol`` of their distance from the origin, the other columns equal.
    Returns the largest relative difference."""
    pa, pb, rel = _ply_pair(a, b)
    err = float(rel.max())
    assert err <= rtol, f"PLY points differ by {err:.3g} (relative)"
    assert np.array_equal(pa[:, 3:], pb[:, 3:]), "PLY colours differ"
    return err


def ply_share(a, b, rtol=WLS_PLY_RTOL, share=MAP_SHARE):
    """Two PLY files with the same vertex count and columns, points within
    ``rtol`` of their distance from the origin on all but ``share`` of
    them, colours as :func:`uint8_close`'s. Returns the share of points
    over ``rtol``."""
    pa, pb, rel = _ply_pair(a, b)
    got = float((rel > rtol).mean())
    assert got <= share, f"{got:.4%} of PLY points differ by over {rtol}"
    uint8_close(pa[:, 3:].astype(np.uint8), pb[:, 3:].astype(np.uint8),
                where="PLY colours")
    return got


def cloud_close(a, b, atol=CLOUD_ATOL):
    """Two (H, W, 3) clouds with the same non-finite pattern and finite
    points within ``atol``. Returns the largest difference."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    fin = np.isfinite(a)
    assert np.array_equal(fin, np.isfinite(b)), "non-finite patterns differ"
    err = float(np.abs(a[fin] - b[fin]).max(initial=0))
    assert err <= atol, f"clouds differ by {err:.3g}"
    return err


def plane_z(cloud, z0, margin=20):
    """(|median z - z0| / z0, 80th percentile of |z - z0| / z0) of a
    cloud of the fronto plane z = z0, ``margin`` px inside its border
    (tests/test_active.py's bounds: 2% and 5%)."""
    z = np.asarray(cloud, np.float64)[margin:-margin, margin:-margin, 2]
    z = z[np.isfinite(z)]
    return (abs(float(np.median(z)) - z0) / z0,
            float(np.percentile(np.abs(z - z0), 80)) / z0)


TSUKUBA_LINE = re.compile(
    r"^(.*?)(?: \(.*\))?: bad-2\.0 = ([\d.]+)%  avgerr = ([\d.]+)px  "
    r"rms = ([\d.]+)px  density = ([\d.]+)%$", re.M)
# Bound on each map's printed bad-2.0 (%) on the stand-in Tsukuba, at
# both sizes, and on example 204's "auto" maps; its fixed "sd" under the
# mismatch must stay above SD_COLLAPSE (%).
TSUKUBA_BAD2 = {"ASW": 8.0, "SGM": 12.0, "GSW": 12.0, "quality preset": 8.0}
AUTO_BAD2 = 12.0
SD_COLLAPSE = 30.0


def tsukuba_lines(text):
    """{name: {bad2, avgerr, rms, density}} of example 010's printout."""
    return {m[0]: dict(zip(("bad2", "avgerr", "rms", "density"),
                           map(float, m[1:])))
            for m in TSUKUBA_LINE.findall(text)}


def tsukuba_close(a, b):
    """Two of example 010's lines within BAD2_POINTS and ERR_PX."""
    for k, tol in (("bad2", BAD2_POINTS), ("density", BAD2_POINTS),
                   ("avgerr", ERR_PX), ("rms", ERR_PX)):
        assert abs(a[k] - b[k]) <= tol, (k, a, b)


AUTO_LINE = re.compile(r"probe EMD ([\d.]+) gray levels -> auto picked "
                       r"'(\w+)', bad-2\.0 ([\d.]+) %")
FIXED_LINE = re.compile(r"fixed '(\w+)' under the mismatch: bad-2\.0 "
                        r"([\d.]+) %")


def auto_lines(text):
    """Example 204's printout: [{emd, pick, bad2} for the matched and the
    mismatched pair, {pick, bad2} of the fixed cost]."""
    out = [dict(emd=float(e), pick=k, bad2=float(b))
           for e, k, b in AUTO_LINE.findall(text)]
    out += [dict(pick=k, bad2=float(b)) for k, b in FIXED_LINE.findall(text)]
    assert len(out) == 3, text
    return out


def single_call(fn, args, kwargs, device):
    """The single-call matcher's map, on ``device``, for a call of the
    tiled matcher ``fn`` (``parallel.tiled_asw_disparity``,
    ``tiled_sgm_disparity`` or ``tiled_gsw_disparity``) with ``args`` and
    ``kwargs``."""
    import inspect
    from simplestereo_tpu_torch.passive import asw_cuda, gsw
    from simplestereo_tpu_torch.passive.sgm import _sgm_disparity
    bound = inspect.signature(fn).bind(*args, **kwargs)
    bound.apply_defaults()
    a = dict(bound.arguments)
    i1, i2 = (torch.as_tensor(np.asarray(a.pop(k)), device=device)
              for k in ("img1", "img2"))
    del a["mesh"], a["row_axis"]
    if fn.__name__ == "tiled_asw_disparity":
        return asw_cuda.asw_disparity(i1, i2, **a)
    if fn.__name__ == "tiled_sgm_disparity":
        bs = a["block_size"]
        a["P1"] = float(8 * bs * bs if a["P1"] is None else a["P1"])
        a["P2"] = float(32 * bs * bs if a["P2"] is None else a["P2"])
        return _sgm_disparity(i1, i2, **a)
    return gsw.gsw_disparity(i1, i2, **a)


def plane_share(disp, lawn, down=1, win=1, max_disp=0):
    """Share of the lawn pair's interior (:func:`plane_interior` for a
    window ``win`` and ``max_disp``, both in pixels of the map) where the
    map ``disp`` of the rectified pair taken every ``down`` pixels lies
    within 1 px of the plane's disparity."""
    rect = lawn["rect"]
    w, h = rect.res1
    truth = true_disparity(rect, lawn["plane"], (h, w))[::down, ::down]
    valid = plane_interior(rect, win // 2 * down,
                           max_disp * down)[::down, ::down]
    assert disp.shape == truth.shape, (disp.shape, truth.shape)
    return float((np.abs(disp - truth / down) <= 1)[valid].mean())


def triangulation_residual(rig, cam, proj, world):
    """How far, in px of camera 1, the points ``world`` that a structured
    light ``rig`` (no distortion) triangulated from the pixel pairs
    ``cam``, ``proj`` are from satisfying both rays, in float64 numpy: each
    point projects through K1 [I|0] onto its camera pixel, and its
    disparity in the rig's rectified frame (the rectifying homographies
    R1, R2 of camera and projector) is that of its pixel pair."""
    X = np.asarray(world, np.float64).reshape(-1, 3)
    cam = np.asarray(cam, np.float64).reshape(-1, 2)
    proj = np.asarray(proj, np.float64).reshape(-1, 2)
    f = rig.intrinsic1[0, 0]

    def col(H, p):
        q = np.concatenate([p, np.ones((len(p), 1))], 1) @ H.T
        return q[:, 0] / q[:, 2]

    u = X @ rig.intrinsic1.T
    on_ray = np.abs(u[:, :2] / u[:, 2:] - cam).max()
    q = (X @ rig.R.T + rig.T.ravel()) @ rig.intrinsic2.T
    seen = col(rig.R2, q[:, :2] / q[:, 2:])
    xc = col(rig.R1, cam)
    disp = np.abs(np.abs(xc - seen) - np.abs(xc - col(rig.R2, proj))).max()
    return max(on_ray, disp * f)
