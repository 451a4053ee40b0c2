"""
graycode
========

Gray-code structured-light scanning: the port of
:mod:`simplestereo_tpu.active.graycode`.

A scan is host loading (paths through the port's :mod:`..imgio`, BGR to
gray on the host), one upload of the whole capture stack as uint8, one
remap of the stack on the channel axis when the camera is distorted,
then the decode (threshold bits, MSB-first prefix XOR from Gray code to
index, validity), the dense epipolar triangulation and the gather of the
valid points, all in torch on the scanner's device. Plain torch serves
every stage: the decode is elementwise over the 2*(nx+ny) planes and the
triangulation per pixel (3x3 products written as sums, so no TF32 can
enter on the card).

``GrayCodeDouble`` keeps the JAX package's corrected semantics of the
reference's latent bugs: R_inv is computed, the correspondence filter
requires all four coordinates, and the half-pixel shift happens in float.
"""

import numpy as np
import torch

from .patterns import graycode_num_bits
from .. import rectification
from .. import warp
from .._device import resolve_device
from ..geometry import npgeom
from ..geometry._small import matmul_small
from ..geometry.distortion import undistort_points
from ..geometry.projection import perspective_transform


def decode_graycode(patterns, nx, ny, white_thr=5, *, device="cuda"):
    """Vectorized Gray-code decode.

    patterns : (2*(nx+ny), H, W) captured images, ordered like
        :func:`graycode_patterns` (bit, inverse, bit, inverse, ...
        columns first then rows). A tensor runs where it is; anything
        else goes to ``device``.

    Returns (proj_x (H,W) int32, proj_y (H,W) int32, valid (H,W) bool)
    tensors; valid requires every bit's |pattern - inverse| >= white_thr
    (the reference's white threshold semantics).
    """
    if not isinstance(patterns, torch.Tensor):
        patterns = torch.as_tensor(np.asarray(patterns),
                                   device=resolve_device(device))
    p = patterns.to(torch.float32)
    pos = p[0::2]
    neg = p[1::2]
    bits = pos > neg
    valid = ((pos - neg).abs() >= white_thr).all(dim=0)

    def gray_to_index(gbits):
        # binary MSB-first prefix-XOR of gray bits
        out = torch.zeros(gbits.shape[1:], dtype=torch.int32,
                          device=gbits.device)
        b = torch.zeros(gbits.shape[1:], dtype=torch.bool,
                        device=gbits.device)
        for i in range(gbits.shape[0]):
            b = b ^ gbits[i]
            out = out * 2 + b.to(torch.int32)
        return out

    return gray_to_index(bits[:nx]), gray_to_index(bits[nx:nx + ny]), valid


def _gray_host(img, res):
    """Host load + grayscale + size check for one capture.

    uint8 in, uint8 out (BGR inputs are grayscaled and rounded back to
    uint8, cv2.cvtColor semantics): the stack upload is the scan's
    largest host-to-device transfer, and uint8 is 4x smaller than float.
    Any other dtype (float captures normalized to [0, 1], >8-bit sensors)
    keeps its VALUES and becomes float32 (quantizing to uint8 would crush
    a [0, 1] stack to {0, 1})."""
    if isinstance(img, (str, bytes)):
        from ..imgio import imread
        img = imread(img, grayscale=True)
    img = np.asarray(img)
    was_u8 = img.dtype == np.uint8
    if img.ndim == 3:
        g = (0.114 * img[..., 0] + 0.587 * img[..., 1]
             + 0.299 * img[..., 2])
        img = np.round(g).astype(np.uint8) if was_u8 else g
    w, h = res
    if img.shape != (h, w):
        raise ValueError("Image size mismatch!")
    if not was_u8 and img.dtype != np.float32:
        img = np.asarray(img, np.float32)
    return img


def _assemble_stack(images, black, white, res, num_patterns):
    """Host half of a scan's loading: the first ``num_patterns`` captures,
    then black and white when both are given (so ``stack[-2]`` is black
    and ``stack[-1]`` white), grayscaled and stacked. Returns
    ``(stack, shadow)``, shadow telling whether black/white are there."""
    imgs = [_gray_host(i, res) for i in images[:num_patterns]]
    shadow = black is not None and white is not None
    if shadow:
        imgs += [_gray_host(black, res), _gray_host(white, res)]
    return np.stack(imgs), shadow


def _undistort_stack(stack, K, dist):
    """Undistort an uploaded (N, H, W) stack in ONE remap: the planes ride
    the channel axis (identical per-plane math; the reference undistorts
    each capture on its own). uint8 stays uint8 (remap rounds integer
    inputs, cv2 semantics). A rig with no distortion skips the
    resample."""
    if dist is None or not np.any(np.asarray(dist)):
        return stack
    _, h, w = stack.shape
    mapx, mapy = warp.init_undistort_rectify_map(K, dist, None, K, (w, h),
                                                 device=stack.device)
    und = warp.remap(stack.permute(1, 2, 0), mapx, mapy)
    return und.permute(2, 0, 1)


def _load_stack(images, black, white, K, dist, res, num_patterns, device):
    """Assemble on the host, upload once, undistort on ``device``.
    Returns ``(und, shadow)``."""
    stack, shadow = _assemble_stack(images, black, white, res, num_patterns)
    return _undistort_stack(torch.as_tensor(stack, device=device), K,
                            dist), shadow


def _decode_validity(und, *, nx, ny, white_thr, res2, black_thr, shadow):
    """Decode + projector-range + shadow validity of an uploaded stack."""
    px, py, valid = decode_graycode(und[: 2 * (nx + ny)], nx, ny,
                                    white_thr=white_thr)
    w2, h2 = res2
    valid = valid & (px < w2) & (py < h2)
    if shadow:
        # strict >, cv2 computeShadowMasks semantics, in float32: a uint8
        # difference would wrap where black > white; exact for 8-bit
        # values and right for float captures
        valid = valid & ((und[-1].to(torch.float32)
                          - und[-2].to(torch.float32)) > black_thr)
    return px, py, valid


def _roi_mask(valid, roi):
    if roi is None:
        return valid
    rx, ry, rw, rh = (int(v) for v in roi)
    H, W = valid.shape
    gx = torch.arange(W, device=valid.device)[None, :]
    gy = torch.arange(H, device=valid.device)[:, None]
    return valid & (gx >= rx) & (gx < rx + rw) & (gy >= ry) & (gy < ry + rh)


def _graycode_cloud(px, py, K2, dist2, Rect1, Rect2, R_inv3, baseline):
    """Dense epipolar triangulation of a decoded scan: (H, W, 3) float32
    points in the camera frame (reference active.py:1227-1260): the
    projector's pixel centres re-distorted through its optics (the
    inverse-pinhole trick, iterative ``undistort_points``), both grids
    rectified, disparity to depth, the common rotation undone."""
    H, W = px.shape
    dev = px.device
    f32 = dict(dtype=torch.float32, device=dev)
    gy, gx = torch.meshgrid(torch.arange(H, **f32), torch.arange(W, **f32),
                            indexing="ij")
    pc = torch.stack([gx + 0.5, gy + 0.5], -1).reshape(-1, 2)
    pp = torch.stack([px.to(torch.float32) + 0.5,
                      py.to(torch.float32) + 0.5], -1).reshape(-1, 2)
    pp = undistort_points(pp, K2, dist2, P=K2)
    pc = perspective_transform(pc, Rect1)
    pp = perspective_transform(pp, Rect2)
    return _depth_from_disparity(pc, pp, R_inv3, baseline).reshape(H, W, 3)


def _depth_from_disparity(pc, pp, R_inv3, baseline):
    """baseline * [pc, 1] / |pp_x - pc_x| with the common rotation undone
    (NaN where the disparity is not above 1e-12)."""
    disparity = (pp[:, :1] - pc[:, :1]).abs()
    pch = torch.cat([pc, torch.ones_like(pc[:, :1])], 1)
    nan = torch.full_like(disparity, float("nan"))
    pw = baseline * pch / torch.where(disparity > 1e-12, disparity, nan)
    R = torch.as_tensor(np.asarray(R_inv3, np.float32), device=pc.device)
    return matmul_small(pw, R.T)


def _torch_dtype(np_dtype):
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


class GrayCode:
    """Camera-projector Gray-code scanner (reference active.py:1130-1263).

    Parameters
    ----------
    rig : StereoRig
        Camera in position 1 (world origin), projector in position 2.
    black_thr : float
        Shadow mask threshold: minimum brightness difference between the
        fully-illuminated (white) and non-illuminated (black) captures for
        a pixel to count as lit by the projector (the cv2
        ``setBlackThreshold`` semantics). Applied when ``black``/``white``
        captures are passed to :meth:`decode`/:meth:`getCloud`.
    white_thr : float
        Minimum pattern-inverse difference per bit.
    device : str or torch.device
        Where the scan's dense work runs (keyword-only, default "cuda").
    """

    def __init__(self, rig, black_thr=40, white_thr=5, *, device="cuda"):
        self.device = resolve_device(device)
        self.rig = rig
        self.black_thr = black_thr
        self.white_thr = white_thr
        self.nx = graycode_num_bits(rig.res2[0])
        self.ny = graycode_num_bits(rig.res2[1])
        self.num_patterns = 2 * (self.nx + self.ny)
        self.Rectify1, self.Rectify2, commonR = \
            rectification._lowLevelRectify(rig)
        R_inv = np.eye(4)
        R_inv[:3, :3] = np.linalg.inv(commonR)
        self.R_inv = R_inv

    def _decode_kw(self, res2):
        return dict(nx=self.nx, ny=self.ny, white_thr=self.white_thr,
                    res2=tuple(res2), black_thr=float(self.black_thr))

    def decode(self, images, black=None, white=None):
        """Decode captured pattern images to per-pixel projector coords.

        black, white : optional captures of the all-black / all-white
            projector frames. When both are given, pixels with
            ``white - black <= black_thr`` are rejected as shadowed.

        Returns (proj_x, proj_y, valid) numpy arrays (H, W).
        """
        rig = self.rig
        und, shadow = _load_stack(images, black, white, rig.intrinsic1,
                                  rig.distCoeffs1, rig.res1,
                                  self.num_patterns, self.device)
        out = _decode_validity(und, shadow=shadow,
                               **self._decode_kw(rig.res2))
        return tuple(t.cpu().numpy() for t in out)

    def _cloud_args(self):
        rig = self.rig
        return (rig.intrinsic2, rig.distCoeffs2, self.Rectify1,
                self.Rectify2, self.R_inv[:3, :3],
                torch.tensor(rig.getBaseline(), dtype=torch.float32,
                             device=self.device))

    def getCloud(self, images, roi=None, black=None, white=None,
                 out_dtype=None):
        """Triangulate a scan to 3D points, (n, 1, 3) in camera frame.

        ``images``: list of camera captures (paths or arrays) ordered like
        the generated patterns; extra trailing images are ignored.
        ``black``/``white``: optional shadow-mask captures (see
        :meth:`decode`). ``roi``: optional (x, y, w, h) camera region.

        Decode, validity and the dense triangulation run on the device;
        the valid points are gathered there too, so only they come back.

        out_dtype : optional numpy dtype for the returned points:
            ``np.float16`` halves the device-to-host transfer by casting
            on the device. Default: float64 output.
        """
        rig = self.rig
        und, shadow = _load_stack(images, black, white, rig.intrinsic1,
                                  rig.distCoeffs1, rig.res1,
                                  self.num_patterns, self.device)
        px, py, valid = _decode_validity(und, shadow=shadow,
                                         **self._decode_kw(rig.res2))
        valid = _roi_mask(valid, roi)
        cloud = _graycode_cloud(px, py, *self._cloud_args())
        return _gather_points(cloud, valid, out_dtype)


def _gather_points(cloud, valid, out_dtype):
    """The valid points of a dense (H, W, 3) cloud, row-major, as an
    (n, 1, 3) numpy array: float64 by default, else ``out_dtype`` (cast
    on the device)."""
    pts = cloud[valid]
    if out_dtype is not None:
        return pts.to(_torch_dtype(out_dtype)).cpu().numpy().reshape(-1, 1, 3)
    return pts.cpu().numpy().astype(np.float64).reshape(-1, 1, 3)


# Alias, reference active.py:1461.
GrayCodeSingle = GrayCode


class GrayCodeDouble:
    """Two cameras + uncalibrated projector (reference active.py:1463-1608,
    with the reference's latent bugs fixed: see the module docstring).

    The projector is only a correspondence oracle: each camera decodes the
    projector pixel seen at every image pixel; camera-camera
    correspondences meeting at the same projector pixel are triangulated
    with the calibrated stereo rig. The decodes run on ``device``; the
    correspondence volume and the triangulation are float64 numpy on the
    host, as in the JAX package.
    """

    def __init__(self, rig, projRes, black_thr=40, white_thr=5, *,
                 device="cuda"):
        self.device = resolve_device(device)
        self.rig = rig
        self.projRes = projRes
        self.black_thr = black_thr
        self.white_thr = white_thr
        self.nx = graycode_num_bits(projRes[0])
        self.ny = graycode_num_bits(projRes[1])
        self.num_patterns = 2 * (self.nx + self.ny)
        self.Rectify1, self.Rectify2, commonR = \
            rectification._lowLevelRectify(rig)
        R_inv = np.eye(4)
        R_inv[:3, :3] = np.linalg.inv(commonR)
        self.R_inv = R_inv

    def _decode_cam(self, images, K, dist, res, black=None, white=None):
        und, shadow = _load_stack(images, black, white, K, dist, res,
                                  self.num_patterns, self.device)
        out = _decode_validity(
            und, nx=self.nx, ny=self.ny, white_thr=self.white_thr,
            res2=tuple(self.projRes), black_thr=float(self.black_thr),
            shadow=shadow)
        return tuple(t.cpu().numpy() for t in out)

    def getCloud(self, images1, images2, roi=None, black1=None, white1=None,
                 black2=None, white2=None):
        """Triangulate; images1/images2 are the two cameras' captures.

        ``black1``/``white1`` (and ``black2``/``white2``): optional
        per-camera all-black / all-white captures for shadow-mask
        rejection.
        """
        px1, py1, v1 = self._decode_cam(
            images1, self.rig.intrinsic1, self.rig.distCoeffs1,
            self.rig.res1, black=black1, white=white1)
        px2, py2, v2 = self._decode_cam(
            images2, self.rig.intrinsic2, self.rig.distCoeffs2,
            self.rig.res2, black=black2, white=white2)

        projW, projH = self.projRes
        # Correspondence volume: mean camera pixel per projector pixel.
        acc = np.zeros((projH, projW, 4))
        cnt = np.zeros((projH, projW, 2))
        for (px, py, v, k) in ((px1, py1, v1, 0), (px2, py2, v2, 1)):
            ys, xs = np.nonzero(v)
            np.add.at(acc[..., 2 * k], (py[ys, xs], px[ys, xs]),
                      xs + 0.5)
            np.add.at(acc[..., 2 * k + 1], (py[ys, xs], px[ys, xs]),
                      ys + 0.5)
            np.add.at(cnt[..., k], (py[ys, xs], px[ys, xs]), 1.0)
        both = (cnt[..., 0] > 0) & (cnt[..., 1] > 0)
        c1 = acc[..., 0:2][both] / cnt[..., 0][both][:, None]
        c2 = acc[..., 2:4][both] / cnt[..., 1][both][:, None]
        if roi is not None:
            roi_x, roi_y, roi_w, roi_h = roi
            keep = ((c1[:, 0] >= roi_x) & (c1[:, 0] < roi_x + roi_w)
                    & (c1[:, 1] >= roi_y) & (c1[:, 1] < roi_y + roi_h))
            c1, c2 = c1[keep], c2[keep]

        p1 = npgeom.perspective_transform(c1, self.Rectify1)
        p2 = npgeom.perspective_transform(c2, self.Rectify2)
        p1 = np.hstack([p1, np.ones((len(p1), 1))])
        disparity = np.abs(p2[:, [0]] - p1[:, [0]])
        disparity[disparity < 1e-12] = np.nan
        pw = self.rig.getBaseline() * (p1 / disparity)
        out = npgeom.perspective_transform(pw.reshape(-1, 1, 3), self.R_inv)
        return out.reshape(-1, 1, 3)
