"""
warp
====

Dense image warping on tensors: the port of :mod:`simplestereo_tpu.warp`.

Replaces the OpenCV warping stack the reference uses: ``cv2.remap``,
``cv2.initUndistortRectifyMap``, ``cv2.undistort`` and
``cv2.getOptimalNewCameraMatrix``. A remap is a gather: each output pixel
reads 1 (nearest), 4 (linear) or 16 (cubic) source pixels through a flat
index. Every function runs on the device of the image it is given;
:func:`init_undistort_rectify_map` takes the ``device`` of its maps.
"""

import numpy as np
import torch
import torch.nn.functional as F

from ._device import resolve_device
from .geometry import npgeom
from .geometry._small import inv_small, matmul_small
from .geometry.distortion import distort_normalized, pad_dist_coeffs


def _gather2d(img, yi, xi):
    """img[(yi, xi)] with integer index tensors; img is (H, W) or (H, W, C).

    A flat take on the linear index. Every caller clamps the indices into
    range first, so no read can leave the image.
    """
    W = img.shape[1]
    lin = yi.long() * W + xi.long()
    if img.dim() == 3:
        C = img.shape[2]
        return img.reshape(-1, C)[lin.reshape(-1)].reshape(lin.shape + (C,))
    return img.reshape(-1)[lin]


def _cubic_weights(t):
    """OpenCV bicubic kernel weights (a = -0.75) for taps at offsets
    -1, 0, 1, 2 around the floor sample; ``t`` is the fractional part."""
    a = -0.75
    w0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    w1 = ((a + 2) * t - (a + 3)) * t * t + 1
    w2 = ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1
    w3 = 1.0 - w0 - w1 - w2
    return [w0, w1, w2, w3]


def _to_input_dtype(out, in_dtype):
    """Integer inputs come back rounded (half to even) and clipped to their
    type's range; float inputs come back float32."""
    if in_dtype.is_floating_point or in_dtype == torch.bool:
        return out
    info = torch.iinfo(in_dtype)
    return torch.clamp(torch.round(out), info.min, info.max).to(in_dtype)


def _coords(mapx, mapy, device):
    return (torch.as_tensor(mapx, dtype=torch.float32, device=device),
            torch.as_tensor(mapy, dtype=torch.float32, device=device))


def remap_row_invariant(image, mapx, mapy, interpolation="linear",
                        border_value=0.0):
    """:func:`remap` for a ROW-CONSTANT image (every row identical).

    The same result as ``remap(image, mapx, mapy, ...)`` when ``image``'s
    rows are all equal, up to float32 ulps, but samples one padded ROW with
    4 (cubic) / 2 (linear) / 1 (nearest) 1-D taps instead of 16/4/1 2-D
    gathers, and folds the y-axis interpolation into a scalar
    inside-the-image weight (interior rows all carry the same sampled
    value; border rows carry ``border_value``). The FTP virtual reference
    uses it: fringe images are row-invariant by construction. Callers must
    check row-invariance (``np.array_equal`` against row 0) before choosing
    this path.
    """
    image = torch.as_tensor(image)
    in_dtype = image.dtype
    if image.dim() != 2:
        raise ValueError("remap_row_invariant expects a (H, W) image!")
    H, W = image.shape
    row = image[0].to(torch.float32)
    x, y = _coords(mapx, mapy, image.device)

    if interpolation == "nearest":
        xi = torch.round(x).to(torch.int32)
        yi = torch.round(y).to(torch.int32)
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        out = torch.where(inside, row[xi.clamp(0, W - 1).long()],
                          border_value)
    elif interpolation in ("linear", "cubic"):
        pad = 1 if interpolation == "linear" else 2
        rpad = F.pad(row, (pad, pad), value=border_value)
        lo = -float(pad)
        xc = torch.clamp(x, lo, float(W) + pad - 1.0) + pad
        yc = torch.clamp(y, lo, float(H) + pad - 1.0) + pad
        x0 = torch.floor(xc).to(torch.int32)
        y0 = torch.floor(yc).to(torch.int32)
        fx = xc - x0
        fy = yc - y0
        Hp, Wp = H + 2 * pad, W + 2 * pad
        if interpolation == "linear":
            x1 = torch.clamp(x0 + 1, 0, Wp - 1)
            x0c = torch.clamp(x0, 0, Wp - 1)
            sx = rpad[x0c.long()] * (1 - fx) + rpad[x1.long()] * fx
            wy = [1 - fy, fy]
            rows = [y0, torch.clamp(y0 + 1, 0, Hp - 1)]
        else:
            wx = _cubic_weights(fx)
            sx = 0.0
            for j in range(4):
                xj = torch.clamp(x0 + j - 1, 0, Wp - 1)
                sx = sx + wx[j] * rpad[xj.long()]
            wy = _cubic_weights(fy)
            rows = [torch.clamp(y0 + i - 1, 0, Hp - 1) for i in range(4)]
        # y-axis: interior padded rows all equal sx; border rows are
        # border_value — same accumulation order as remap's i-loop
        out = 0.0
        for wyi, ri in zip(wy, rows):
            inside = (ri >= pad) & (ri <= Hp - 1 - pad)
            out = out + wyi * torch.where(inside, sx, border_value)
    else:
        raise ValueError(f"Unknown interpolation: {interpolation}")

    return _to_input_dtype(out, in_dtype)


def remap(image, mapx, mapy, interpolation="linear", border_value=0.0):
    """Resample ``image`` at float coordinates — drop-in for ``cv2.remap``.

    ``out[y, x] = image[mapy[y, x], mapx[y, x]]`` with sub-pixel
    interpolation and constant border, matching OpenCV's default
    ``BORDER_CONSTANT`` semantics: samples falling outside blend with the
    border value.

    Parameters
    ----------
    image : torch.Tensor
        (H, W) or (H, W, C), any real dtype.
    mapx, mapy : torch.Tensor
        (Ho, Wo) float source coordinates.
    interpolation : str
        'nearest' | 'linear' | 'cubic'  (cubic uses OpenCV's a=-0.75 kernel).
    border_value : float
        Fill value for out-of-image samples.

    Returns
    -------
    torch.Tensor
        (Ho, Wo[, C]) resampled image on the image's device, same dtype as
        the input for integer inputs (rounded), float32 otherwise.
    """
    image = torch.as_tensor(image)
    in_dtype = image.dtype
    chan = image.dim() == 3
    H, W = image.shape[:2]
    x, y = _coords(mapx, mapy, image.device)

    imgf = image.to(torch.float32)

    def padded(pad):
        spec = ((0, 0) if chan else ()) + (pad, pad, pad, pad)
        return F.pad(imgf, spec, value=border_value)

    def per_channel(w):
        return w[..., None] if chan else w

    if interpolation == "nearest":
        xi = torch.round(x).to(torch.int32)
        yi = torch.round(y).to(torch.int32)
        inside = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        out = _gather2d(imgf, torch.clamp(yi, 0, H - 1),
                        torch.clamp(xi, 0, W - 1))
        out = torch.where(per_channel(inside), out, border_value)
    elif interpolation == "linear":
        pad = 1
        img_p = padded(pad)
        xc = torch.clamp(x, -1.0, float(W)) + pad
        yc = torch.clamp(y, -1.0, float(H)) + pad
        x0 = torch.floor(xc).to(torch.int32)
        y0 = torch.floor(yc).to(torch.int32)
        fx = per_channel(xc - x0)
        fy = per_channel(yc - y0)
        Hp, Wp = H + 2 * pad, W + 2 * pad
        x1 = torch.clamp(x0 + 1, 0, Wp - 1)
        y1 = torch.clamp(y0 + 1, 0, Hp - 1)
        x0 = torch.clamp(x0, 0, Wp - 1)
        y0 = torch.clamp(y0, 0, Hp - 1)
        v00 = _gather2d(img_p, y0, x0)
        v01 = _gather2d(img_p, y0, x1)
        v10 = _gather2d(img_p, y1, x0)
        v11 = _gather2d(img_p, y1, x1)
        out = (
            v00 * (1 - fx) * (1 - fy)
            + v01 * fx * (1 - fy)
            + v10 * (1 - fx) * fy
            + v11 * fx * fy
        )
    elif interpolation == "cubic":
        pad = 2
        img_p = padded(pad)
        xc = torch.clamp(x, -2.0, float(W) + 1.0) + pad
        yc = torch.clamp(y, -2.0, float(H) + 1.0) + pad
        x0 = torch.floor(xc).to(torch.int32)
        y0 = torch.floor(yc).to(torch.int32)
        wx = _cubic_weights(xc - x0)
        wy = _cubic_weights(yc - y0)
        Hp, Wp = H + 2 * pad, W + 2 * pad
        out = 0.0
        for i in range(4):
            yi = torch.clamp(y0 + i - 1, 0, Hp - 1)
            row = 0.0
            for j in range(4):
                xj = torch.clamp(x0 + j - 1, 0, Wp - 1)
                row = row + per_channel(wx[j]) * _gather2d(img_p, yi, xj)
            out = out + per_channel(wy[i]) * row
    else:
        raise ValueError(f"Unknown interpolation: {interpolation}")

    return _to_input_dtype(out, in_dtype)


def _compute_rectify_map(K, dist14, R, newP, size, device):
    """Maps of :func:`init_undistort_rectify_map` from float32 (3, 3) CPU
    tensors ``K``, ``R``, ``newP`` and the (14,) coefficients.

    The 3x3 inverse runs on the host: on the card it would be a solver
    launch and a synchronisation for nine numbers. Everything of image
    size runs on ``device``.
    """
    w, h = size
    iR = inv_small(matmul_small(newP, R)).to(device)
    K = K.to(device)
    u = torch.arange(w, dtype=torch.float32, device=device)[None, :]
    v = torch.arange(h, dtype=torch.float32, device=device)[:, None]

    X = iR[0, 0] * u + iR[0, 1] * v + iR[0, 2]
    Y = iR[1, 0] * u + iR[1, 1] * v + iR[1, 2]
    Wc = iR[2, 0] * u + iR[2, 1] * v + iR[2, 2]
    xn = X / Wc
    yn = Y / Wc

    dpts = distort_normalized(torch.stack([xn, yn], dim=-1),
                              dist14.to(device))
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    skew = K[0, 1]
    mapx = fx * dpts[..., 0] + skew * dpts[..., 1] + cx
    mapy = fy * dpts[..., 1] + cy
    return mapx, mapy


def init_undistort_rectify_map(camera_matrix, dist_coeffs, R, new_camera_matrix,
                               size, *, device="cuda"):
    """Build undistort+rectify sampling maps — drop-in for
    ``cv2.initUndistortRectifyMap`` (CV_32FC1 output flavor).

    For every destination pixel: back-project through
    ``(new_camera_matrix @ R)^-1``, apply forward lens distortion, and
    project through the *original* intrinsics. No iterative inversion is
    needed in this direction.

    Parameters
    ----------
    camera_matrix : array
        3x3 original intrinsics.
    dist_coeffs : array or None
    R : array or None
        3x3 rectification transform (object-space, OpenCV convention).
    new_camera_matrix : array
        3x3 (or 3x4, first 3 cols used) new projection.
    size : tuple
        (width, height) of the destination image.
    device : str or torch.device
        Where the maps are built and kept. Default ``"cuda"``.

    Returns
    -------
    (mapx, mapy) : torch.Tensor
        Two (height, width) float32 maps for :func:`remap`.
    """
    def f32(m):
        return torch.as_tensor(np.asarray(m, np.float32)).reshape(3, -1)[:, :3]

    K = f32(camera_matrix)
    d = pad_dist_coeffs(None if dist_coeffs is None
                        else np.asarray(dist_coeffs, np.float32))
    Rm = torch.eye(3) if R is None else f32(R)
    return _compute_rectify_map(K, d, Rm, f32(new_camera_matrix),
                                (int(size[0]), int(size[1])),
                                resolve_device(device))


def undistort_image(image, camera_matrix, dist_coeffs, new_camera_matrix=None,
                    interpolation="linear"):
    """Undistort an image — drop-in for ``cv2.undistort``.

    Parameters
    ----------
    image : torch.Tensor
        (H, W[, C]) image; the maps are built on its device.
    camera_matrix : array
        3x3 intrinsics.
    dist_coeffs : array or None
    new_camera_matrix : array, optional
        Defaults to ``camera_matrix``.

    Returns
    -------
    torch.Tensor
        Undistorted image, same shape/dtype.
    """
    image = torch.as_tensor(image)
    h, w = image.shape[:2]
    nK = camera_matrix if new_camera_matrix is None else new_camera_matrix
    mapx, mapy = init_undistort_rectify_map(camera_matrix, dist_coeffs, None,
                                            nK, (w, h), device=image.device)
    return remap(image, mapx, mapy, interpolation=interpolation)


def get_optimal_new_camera_matrix(camera_matrix, dist_coeffs, image_size, alpha,
                                  new_image_size=None, center_principal_point=False):
    """New intrinsics trading off valid-pixel crop vs full field of view.

    Equivalent of ``cv2.getOptimalNewCameraMatrix``, a copy of the JAX
    package's numpy function. Computes the outer (all pixels) and inner
    (only valid pixels) rectangles of the undistorted image from an N x N
    border grid, then blends with ``alpha``.

    Returns
    -------
    (new_camera_matrix, roi) : (numpy.ndarray, tuple)
        3x3 matrix and (x, y, w, h) valid ROI — mirroring OpenCV's API.
    """
    K = np.asarray(camera_matrix, np.float64).reshape(3, 3)
    w, h = int(image_size[0]), int(image_size[1])
    if new_image_size is None:
        new_image_size = (w, h)
    nw, nh = int(new_image_size[0]), int(new_image_size[1])

    N = 9
    # Border grid of the source image (OpenCV icvGetRectangles uses a 9x9 grid
    # over the full image; rectangles come from the undistorted grid).
    xs = np.linspace(0, w - 1, N)
    ys = np.linspace(0, h - 1, N)
    gx, gy = np.meshgrid(xs, ys)
    pts = np.stack([gx.ravel(), gy.ravel()], axis=-1)
    und = npgeom.undistort_points(pts, K, dist_coeffs).reshape(N, N, 2)

    # Outer rect: bounding box of all undistorted grid points.
    ox0, oy0 = und[..., 0].min(), und[..., 1].min()
    ox1, oy1 = und[..., 0].max(), und[..., 1].max()

    # Inner rect: per-side extrema so that every border row/column is inside.
    ix0 = und[:, 0, 0].max()     # left column → max x
    ix1 = und[:, -1, 0].min()    # right column → min x
    iy0 = und[0, :, 1].max()     # top row → max y
    iy1 = und[-1, :, 1].min()    # bottom row → min y

    def k_from_rect(x0, y0, x1, y1):
        fx = (nw - 1) / max(x1 - x0, 1e-9)
        fy = (nh - 1) / max(y1 - y0, 1e-9)
        cx = -fx * x0
        cy = -fy * y0
        return np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float64)

    K_outer = k_from_rect(ox0, oy0, ox1, oy1)
    K_inner = k_from_rect(ix0, iy0, ix1, iy1)

    newK = K_inner * (1 - alpha) + K_outer * alpha
    newK[2, 2] = 1.0
    if center_principal_point:
        newK[0, 2] = (nw - 1) * 0.5
        newK[1, 2] = (nh - 1) * 0.5

    # Valid ROI: the inner rectangle (normalized coords) through newK.
    def mapped(x, y):
        v = newK @ np.array([x, y, 1.0])
        return v[:2] / v[2]

    tl = mapped(ix0, iy0)
    br = mapped(ix1, iy1)
    x0r, y0r = int(np.ceil(tl[0])), int(np.ceil(tl[1]))
    x1r, y1r = int(np.floor(br[0])), int(np.floor(br[1]))
    x0r, y0r = max(x0r, 0), max(y0r, 0)
    roi = (x0r, y0r, max(x1r - x0r, 0), max(y1r - y0r, 0))
    return newK, roi


def map_coordinates(image, coords, order=1):
    """Sample ``image`` at (y, x) float coordinates (scipy-style).

    Equivalent of ``scipy.ndimage.map_coordinates`` as the reference's
    phase-shift calibration uses it for sub-pixel phase sampling.

    Parameters
    ----------
    image : torch.Tensor
        (H, W) array.
    coords : torch.Tensor
        (2, N) stacked (y, x) sample positions.
    order : int
        0 (nearest), 1 (bilinear) or 3 (bicubic).

    Returns
    -------
    torch.Tensor
        (N,) sampled values.
    """
    image = torch.as_tensor(image)
    coords = torch.as_tensor(coords, device=image.device)
    y, x = coords[0], coords[1]
    interp = {0: "nearest", 1: "linear", 3: "cubic"}[order]
    out = remap(image, x.reshape(1, -1), y.reshape(1, -1), interpolation=interp)
    return out.reshape(-1)
