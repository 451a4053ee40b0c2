"""
points
======

Point-cloud management: PLY export/import, disparity reprojection. The
port of :mod:`simplestereo_tpu.points`.

The reprojection runs on a device (float32, the products in the JAX
package's order); :func:`distortPoints` is a numpy copy. The PLY writer
and reader are host C++ (:mod:`.native`, the port of the JAX package's
serializer, built with g++ at first use); the files are byte-identical to
the JAX package's. ``_export_ply_plain``/``_import_ply_plain`` are the
same work through ``numpy.savetxt``/``numpy.loadtxt``, which the tests
hold the native code against.
"""

import numpy as np
import torch

from . import native
from ._device import resolve_device


def _ply_header(points3D, referenceImage):
    """(header lines, (n, 3) points, reference image or None, kind): kind
    is "xyz", "rgb", "int" or "float", as the JAX package's exportPLY
    chooses it."""
    points3D = np.asarray(points3D)
    originalShape = points3D.shape
    pts = points3D.reshape(-1, 3)
    header = [
        "ply",
        "format ascii 1.0",
        "comment SimpleStereo point cloud export",
        f"comment Original array shape {'x'.join(str(d) for d in originalShape)}",
        f"element vertex {pts.shape[0]}",
        "property double x",
        "property double y",
        "property double z",
    ]
    kind = "xyz"
    if referenceImage is not None:
        referenceImage = np.asarray(referenceImage)
        if referenceImage.size == pts.size:  # BGR color image
            header += [
                "property uchar red",
                "property uchar green",
                "property uchar blue",
            ]
            kind = "rgb"
        elif np.issubdtype(referenceImage.dtype, np.integer):
            header.append("property int intensity")
            kind = "int"
        else:
            header.append("property float intensity")
            kind = "float"
    header.append("end_header")
    return header, pts, referenceImage, kind


def exportPLY(points3D, filepath, referenceImage=None, precision=6):
    """Export a point cloud to ASCII PLY.

    Matches the reference format: double x/y/z properties, optional
    per-vertex color from a BGR image (written as RGB uchar) or a grayscale
    intensity (int or float), and a header comment recording the original
    array shape. Written by the native writer (:mod:`.native`, built at
    first use); the file is byte-identical to the JAX package's.

    Parameters
    ----------
    points3D : numpy.ndarray
        (..., 3) points; flattened for writing.
    filepath : str
    referenceImage : numpy.ndarray, optional
        Color source. Same number of pixels as points: 3 channels = BGR,
        otherwise treated as grayscale intensity.
    precision : int
        Decimal places for coordinates.
    """
    header, pts, ref, kind = _ply_header(points3D, referenceImage)
    header = ("\n".join(header) + "\n").encode()
    if kind == "xyz":
        native.write_ply(filepath, header, pts, precision=precision)
    elif kind == "rgb":
        native.write_ply(filepath, header, pts,
                         rgb=ref.reshape(-1, 3)[:, ::-1], precision=precision)
    else:
        native.write_ply(filepath, header, pts, vals=np.ravel(ref),
                         as_int=kind == "int", precision=precision)


def _export_ply_plain(points3D, filepath, referenceImage=None, precision=6):
    """:func:`exportPLY` through ``numpy.savetxt``: the same bytes, for the
    tests to hold the native writer against."""
    header, pts, ref, kind = _ply_header(points3D, referenceImage)
    fmt = " ".join([f"%.{precision}f"] * 3)
    body = pts
    if kind == "rgb":
        body = np.hstack([pts, ref.reshape(-1, 3)[:, ::-1].astype(np.float64)])
        fmt += " %d %d %d"
    elif kind != "xyz":
        body = np.hstack([pts, np.ravel(ref)[:, None].astype(np.float64)])
        fmt += " %d" if kind == "int" else f" %.{precision}f"
    with open(filepath, "w") as f:
        f.write("\n".join(header) + "\n")
        np.savetxt(f, body, fmt=fmt)


def _ply_layout(filename):
    """(lines up to end_header, vertex count, property count) of a PLY
    file's header."""
    n_skip, n_vertex, n_cols = 0, None, 0
    with open(filename, "r") as f:
        for line in f:
            n_skip += 1
            t = line.split()
            if t[:2] == ["element", "vertex"]:
                n_vertex = int(t[2])
            elif t and t[0] == "property":
                n_cols += 1
            if line.rstrip().lower() == "end_header":
                return n_skip, n_vertex, n_cols
    raise ValueError(f"{filename!r}: no end_header line")


def importPLY(filename, *properties):
    """Read float property columns from an ASCII PLY file.

    Skips to ``end_header`` then parses the requested column indices
    (default (0, 1, 2)) as floats, with the native parser.

    Returns
    -------
    numpy.ndarray
        (N, len(properties)) float array.
    """
    if not properties:
        properties = (0, 1, 2)
    n_skip, n_vertex, n_cols = _ply_layout(filename)
    if n_vertex is None or n_cols == 0:
        raise ValueError(f"{filename!r}: the header names no vertex "
                         "element or no property")
    data = native.read_ply(filename, n_skip, n_vertex, n_cols)
    return data[:, list(properties)]


def _import_ply_plain(filename, *properties):
    """:func:`importPLY` through ``numpy.loadtxt``, for the tests."""
    if not properties:
        properties = (0, 1, 2)
    with open(filename, "r") as f:
        for line in f:
            if line.rstrip().lower() == "end_header":
                break
        data = np.loadtxt(f, dtype=np.float64, ndmin=2)
    return data[:, list(properties)]


def _reproject_q(disparity, Q):
    """(H, W) disparity tensor and a (4, 4) float32 Q on its device ->
    (H, W, 3) float32 points."""
    H, W = disparity.shape
    xx = torch.arange(W, dtype=torch.float32, device=disparity.device)[None, :]
    yy = torch.arange(H, dtype=torch.float32, device=disparity.device)[:, None]
    d = disparity.to(torch.float32)
    X = Q[0, 0] * xx + Q[0, 1] * yy + Q[0, 2] * d + Q[0, 3]
    Y = Q[1, 0] * xx + Q[1, 1] * yy + Q[1, 2] * d + Q[1, 3]
    Z = Q[2, 0] * xx + Q[2, 1] * yy + Q[2, 2] * d + Q[2, 3]
    Wc = Q[3, 0] * xx + Q[3, 1] * yy + Q[3, 2] * d + Q[3, 3]
    inv = 1.0 / Wc
    return torch.stack([X * inv, Y * inv, Z * inv], dim=-1)


def reprojectImageTo3D(disparityMap, Q, *, device="cuda"):
    """Dense disparity -> (H, W, 3) float32 numpy points through a 4x4 Q.

    Equivalent of ``cv2.reprojectImageTo3D``. A tensor runs on its own
    device; anything else is copied to ``device`` (default ``"cuda"``).
    Division by a zero homogeneous coordinate (disparity that maps to W=0)
    produces inf, as in OpenCV — callers should mask invalid disparities.
    """
    if isinstance(disparityMap, torch.Tensor):
        disp = disparityMap
    else:
        disp = torch.tensor(np.asarray(disparityMap),
                            device=resolve_device(device))
    Qt = torch.as_tensor(np.asarray(Q, np.float32).reshape(4, 4),
                         device=disp.device)
    return _reproject_q(disp, Qt).cpu().numpy()


def getAdimensional3DPoints(disparityMap, *, device="cuda"):
    """Rig-less disparity reprojection with synthetic intrinsics.

    Same synthetic Q as the reference: f = width, principal point at the
    image center, unit baseline. Useful for quick non-metric 3D previews of
    any disparity map. Runs where :func:`reprojectImageTo3D` does.
    """
    height, width = disparityMap.shape[:2]

    b, fx, fy = 1.0, float(width), float(width)
    cx1 = cx2 = width / 2
    a1 = a2 = 0.0
    cy = height / 2

    Q = np.eye(4, dtype=np.float64)
    Q[0, 1] = -a1 / fy
    Q[0, 3] = a1 * cy / fy - cx1
    Q[1, 1] = fx / fy
    Q[1, 3] = -cy * fx / fy
    Q[2, 2] = 0
    Q[2, 3] = -fx
    Q[3, 1] = (a2 - a1) / (fy * b)
    Q[3, 2] = 1 / b
    Q[3, 3] = ((a1 - a2) * cy + (cx2 - cx1) * fy) / (fy * b)

    return reprojectImageTo3D(disparityMap, Q, device=device)


def distortPoints(points, distCoeff):
    """Forward-distort normalized points with the reference's polynomial model.

    NOTE: the reference's ``points.distortPoints`` uses a *purely
    polynomial* radial model where k4..k6 are additional numerator terms
    (r^8..r^12), NOT the OpenCV rational model. This function keeps that
    exact behavior for parity; for the OpenCV-compatible rational model use
    :func:`simplestereo_tpu_torch.geometry.distort_normalized`.

    Parameters
    ----------
    points : array
        (N, 1, 2) or (N, 2) normalized undistorted coordinates.
    distCoeff : array
        4, 5 or 8 coefficients (k1, k2, p1, p2[, k3[, k4, k5, k6]]).

    Returns
    -------
    numpy.ndarray
        (N, 1, 2) distorted normalized coordinates.
    """
    distCoeff = np.asarray(distCoeff, np.float64).ravel()
    n = distCoeff.shape[0]
    if n not in (4, 5, 8):
        raise ValueError(f"distCoeff is not in a valid format! (length {n} unexpected)")
    k1, k2, p1, p2, k3, k4, k5, k6 = np.concatenate([distCoeff, np.zeros(8 - n)])

    pts = np.asarray(points, np.float64).reshape(-1, 2)
    x, y = pts[:, 0], pts[:, 1]
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3 + k4 * r2**4 + k5 * r2**5 + k6 * r2**6
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([xd, yd], axis=-1).reshape(-1, 1, 2)
