"""
ftp
===

Stereo Fourier Transform Profilometry (modified FTP with a virtual
reference plane) and its variants: the port of
:mod:`simplestereo_tpu.active.ftp` (reference active.py:351-841,
:844-1128, :1266-1450, :1703-2074; method: P. Lafiosca et al.,
"Automated Aircraft Dent Inspection via a Modified Fourier Transform
Profilometry Algorithm", Sensors 22(2):433, 2022).

The split is the JAX package's:

- dense work (camera undistortion, the projector-mapping grid, the cubic
  resample of the virtual reference, the per-row FFT / band-pass /
  inverse FFT / phase, the 2-D unwrap, the dense triangulation) is torch
  on the scanner's device: ``torch.fft`` in complex64 along rows, the
  small matrix products written out as sums (no TF32 on the card);
- the small control plane (stripe triangulation, per-row carrier
  frequency, the reference-plane depth) is float64 numpy on the host.

The JAX package's ``vmap`` over a frame stack is a batch dimension here:
every dense function takes a leading frame axis, and a single frame is a
stack of one.
"""

import math

import numpy as np
import torch

from .patterns import _getCentralPeak
from .stripe import (_CHANNEL, _centroids_to_stripe,
                     _stripe_centroids_device, findCentralStripe)
from .graycode import _depth_from_disparity, _torch_dtype
from .. import rectification
from .. import unwrapping
from .. import warp
from .._device import resolve_device
from ..geometry.distortion import pad_dist_coeffs  # noqa: F401
from ..geometry import npgeom
from ..geometry._small import apply_affine
from ..geometry.distortion import distort_normalized, undistort_points
from ..geometry.projection import perspective_transform


def _f32(x, device):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def _projector_mapping(z, M, T, K2, dist2, fringe_gray, res, row_inv):
    """Dense camera-grid -> projector mapping + virtual reference image,
    for each reference-plane depth of the (B,) tensor ``z``.

    The reference's double-grid trick (active.py:432-492): M = R @ K1^-1
    sends camera pixels to rays, z puts them on the reference plane, the
    projector (with its distortion) maps them back: for the half-pixel
    grid the exact projector coordinates, for the integer grid the
    sampling map of the virtual reference image. Returns
    ((B, h, w, 2), (B, h, w)) float32 tensors on z's device.
    """
    w, h = res
    f32 = dict(dtype=torch.float32, device=z.device)
    gy, gx = torch.meshgrid(torch.arange(h, **f32), torch.arange(w, **f32),
                            indexing="ij")
    zb = z.reshape(-1, 1, 1)

    def project(gx, gy):
        q = [zb * m + T[i] for i, m in enumerate(apply_affine(M, [gx, gy]))]
        xyd = distort_normalized(torch.stack([q[0] / q[2], q[1] / q[2]], -1),
                                 dist2)
        u = K2[0, 0] * xyd[..., 0] + K2[0, 1] * xyd[..., 1] + K2[0, 2]
        v = K2[1, 1] * xyd[..., 1] + K2[1, 2]
        return u, v

    uc, vc = project(gx + 0.5, gy + 0.5)
    proj_coords = torch.stack([uc, vc], dim=-1)
    ui, vi = project(gx, gy)
    if row_inv:
        # Every fringe row is the same (checked at construction): sample
        # one padded row with 4 cubic taps instead of the 16-tap 2-D
        # gather; same semantics (warp.remap_row_invariant).
        virtual_ref = warp.remap_row_invariant(fringe_gray, ui, vi,
                                               interpolation="cubic")
    else:
        virtual_ref = warp.remap(fringe_gray, ui, vi, interpolation="cubic")
    return proj_coords, virtual_ref


def _phase_pipeline(img_obj, img_ref, fmin, fmax):
    """Row-FFT band-pass phase extraction (active.py:679-737).

    img_obj, img_ref : (..., H, W) float grayscale; fmin, fmax: (..., H)
    per-row band edges in cycles/pixel. Returns the wrapped phase
    difference, float32.
    """
    G0 = torch.fft.fft(img_ref.to(torch.complex64), dim=-1)
    G = torch.fft.fft(img_obj.to(torch.complex64), dim=-1)
    freqs = torch.fft.fftfreq(img_obj.shape[-1], dtype=torch.float64,
                              device=img_obj.device).to(torch.float32)
    keep = ((freqs - fmin[..., None] >= 0) & (freqs - fmax[..., None] <= 0))
    zero = torch.zeros((), dtype=torch.complex64, device=G.device)
    g0hat = torch.fft.ifft(torch.where(keep, G0, zero), dim=-1)
    ghat = torch.fft.ifft(torch.where(keep, G, zero), dim=-1)
    return torch.angle(ghat * torch.conj(g0hat))


def _unwrap2d(phase):
    """np.unwrap along x then along y (active.py:739-743), for a
    (..., H, W) tensor."""
    return unwrapping.unwrap(unwrapping.unwrap(phase, axis=-1), axis=-2)


def _index(idx, size):
    """Indices into an axis of ``size`` by jnp's gather rules: a negative
    index counts from the end, and one still out of range is clamped."""
    idx = torch.where(idx < 0, idx + size, idx)
    return idx.clamp(0, size - 1)


def _prep_undistort_centroids(imgs, K1, dist1, thr, *, roi, channel):
    """Camera undistortion, ROI crop and the per-row stripe centroids of a
    (B, H, W, 3) tensor stack on its device. The frames ride the channel
    axis of one remap. Returns the cropped (B, rh, rw, 3) stack and the
    (B, rh) float32 centroid vectors (NaN where a row has no stripe)."""
    B, H, W, C = imgs.shape
    mapx, mapy = warp.init_undistort_rectify_map(K1, dist1, None, K1, (W, H),
                                                 device=imgs.device)
    und = warp.remap(imgs.permute(1, 2, 0, 3).reshape(H, W, B * C), mapx,
                     mapy)
    und = und.reshape(H, W, B, C).permute(2, 0, 1, 3)
    rx, ry, rw, rh = roi
    und = und[:, ry:ry + rh, rx:rx + rw]
    return und, _stripe_centroids_device(und, channel, thr)


def _dense_cloud(projCoords, phaseUnwrapped, k, ep, fp, K2, dist2, Rect1,
                 Rect2, R_inv3, baseline, roi_x, row0):
    """Dense epipolar triangulation (active.py:793-838) of a (B, rows, rw)
    unwrapped phase with (B,) fringe orders ``k``: projector points from
    phase, the projector's re-distortion (iterative
    ``undistort_points``), rectification of both grids, disparity and
    depth. ``row0`` is the image row of the first row. Returns
    (B, rows, rw, 3) float32."""
    B, rows, roi_w = phaseUnwrapped.shape
    dev = phaseUnwrapped.device
    f32 = dict(dtype=torch.float32, device=dev)
    two_pi = torch.tensor(2 * math.pi, **f32)
    phase = phaseUnwrapped + k.reshape(-1, 1, 1) * two_pi
    Xa = projCoords[..., 0]
    Ya = projCoords[..., 1]
    Xh = Xa + phase / (two_pi * fp)
    Yh = ((Xh - ep[0]) / (Xa - ep[0])) * (Ya - ep[1]) + ep[1]
    Hp = undistort_points(torch.stack([Xh, Yh], -1), K2, dist2, P=K2)
    gy, gx = torch.meshgrid(torch.arange(rows, **f32),
                            torch.arange(roi_w, **f32), indexing="ij")
    pc = torch.stack([gx + roi_x + 0.5, gy + row0 + 0.5], -1)
    pc = perspective_transform(pc, Rect1)
    pp = perspective_transform(Hp, Rect2)
    pc = pc.expand_as(pp).reshape(-1, 2)
    return _depth_from_disparity(pc, pp.reshape(-1, 2), R_inv3,
                                 baseline).reshape(B, rows, roi_w, 3)


def _gray_frames(imgs, gray_mode):
    """(B, rh, rw) float32 grayscale of a (B, rh, rw, 3) stack: "max" keeps
    the stripe white; "br" is the normalized B - R difference [Guo 1990];
    "host": the frames are already gray."""
    if gray_mode == "br":
        d = imgs[..., 0].to(torch.float32) - imgs[..., 2].to(torch.float32)
        dmin = d.amin(dim=(-2, -1), keepdim=True)
        ptp = d.amax(dim=(-2, -1), keepdim=True) - dmin
        return (d - dmin) / torch.where(ptp > 0, ptp, torch.ones_like(ptp))
    if gray_mode == "host":
        return imgs.to(torch.float32)
    return imgs.amax(dim=-1).to(torch.float32)


def _ftp_cloud_fused(imgs, zs, M, T, K2, dist2, fringe_gray, fmins, fmaxs,
                     stripe_idxs, peak, fp, ep, Rect1, Rect2, R_inv3,
                     baseline, *, res, roi, gray_mode, debug=False,
                     row_inv=False):
    """The whole post-stripe FTP pipeline on a (B, ...) stack: grayscale,
    projector mapping + virtual reference, row-FFT band-pass phase, 2-D
    unwrap, fringe order k from the stripe, dense triangulation. Returns
    the (B, rh, rw, 3) float32 cloud, and with ``debug`` a dict of the
    spectra, phases and k."""
    roi_x, roi_y, roi_w, roi_h = roi
    gray = _gray_frames(imgs, gray_mode)
    proj_coords, virtual_ref = _projector_mapping(
        zs, M, T, K2, dist2, fringe_gray, res, row_inv)
    proj_coords = proj_coords[:, roi_y:roi_y + roi_h, roi_x:roi_x + roi_w]
    virtual_ref = virtual_ref[:, roi_y:roi_y + roi_h, roi_x:roi_x + roi_w]

    phase = _phase_pipeline(gray, virtual_ref, fmins, fmaxs)
    pu = _unwrap2d(phase)

    bi = torch.arange(pu.shape[0], device=pu.device)[:, None]
    sy = _index(stripe_idxs[..., 1], roi_h)
    sx = _index(stripe_idxs[..., 0], roi_w)
    theta = pu[bi, sy, sx]
    u_A = proj_coords[bi, sy, sx, 0]
    two_pi = torch.tensor(2 * math.pi, dtype=torch.float32, device=pu.device)
    k = (peak - u_A) * fp - theta / two_pi
    k = torch.ceil(k.mean(dim=1) - 0.5)

    cloud = _dense_cloud(proj_coords, pu, k, ep, fp, K2, dist2, Rect1, Rect2,
                         R_inv3, baseline, roi_x,
                         torch.tensor(float(roi_y), dtype=torch.float32,
                                      device=pu.device))
    if not debug:
        return cloud
    dbg = dict(
        spectrum=torch.fft.fft(gray.to(torch.complex64), dim=-1).abs(),
        spectrum_ref=torch.fft.fft(virtual_ref.to(torch.complex64),
                                   dim=-1).abs(),
        phase=phase, phase_unwrapped=pu, k=k)
    return cloud, dbg


def _render_ftp_debug(dump, plot):
    """Render the getCloud debug dump (the reference's plot=True
    spectrum/phase windows, active.py:688-714, :747-755). ``plot`` may be
    True (interactive ``plt.show()``) or a path to save the figure to.
    matplotlib is imported here only."""
    import matplotlib
    if plot is not True:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    H, W = np.asarray(dump["phase_unwrapped"]).shape
    fig, axes = plt.subplots(2, 2, figsize=(11, 7))
    row = H // 2
    freqs = np.fft.fftfreq(W)[: W // 2]
    for key, ax in (("spectrum", axes[0, 0]), ("spectrum_ref", axes[0, 1])):
        if key in dump:
            ax.plot(freqs, np.asarray(dump[key])[row, : W // 2])
            if "fmin" in dump and "fmax" in dump:
                ax.axvline(float(np.asarray(dump["fmin"])[row]), ls="--")
                ax.axvline(float(np.asarray(dump["fmax"])[row]), ls="--")
            ax.set_title(f"{key} (row {row})")
            ax.set_xlabel("cycles/pixel")
    im = axes[1, 0].imshow(np.asarray(dump["phase"]), cmap="twilight")
    axes[1, 0].set_title("wrapped phase")
    fig.colorbar(im, ax=axes[1, 0])
    im = axes[1, 1].imshow(np.asarray(dump["phase_unwrapped"]))
    axes[1, 1].set_title("unwrapped phase")
    fig.colorbar(im, ax=axes[1, 1])
    fig.tight_layout()
    if plot is True:
        plt.show()
    else:
        fig.savefig(plot, dpi=100)
        plt.close(fig)


class StereoFTP:
    """Stereo Fourier Transform Profilometry manager.

    Parameters (reference active.py:379-401)
    ----------
    stereoRig : StereoRig
        Camera in position 1 (world origin), projector in position 2.
    fringe : numpy.ndarray
        The projected BGR fringe image (built by :func:`buildFringe` with
        a central stripe).
    period : float
        Fringe period on the projector, in pixels.
    shift, stripeColor, stripeSensitivity : see the reference.
    device : str or torch.device
        Where the dense work runs (keyword-only, default "cuda").
    """

    _GRAY_MODE = "max"  # fused-path grayscale (see convertGrayscale)

    def __init__(self, stereoRig, fringe, period, shift=0,
                 stripeColor="red", stripeSensitivity=0.5, *,
                 device="cuda"):
        self.device = resolve_device(device)
        fringe = np.asarray(fringe)
        # The reference fringe must be grayscaled by the SAME hook that
        # grayscales the camera captures (see _grayscale_plan): mixing
        # hooks would mismatch the object and reference phases.
        if self._grayscale_plan() == "device":
            gray = self.convertGrayscaleDevice(
                torch.as_tensor(fringe, device=self.device))
            gray = gray.cpu().numpy().astype(np.float64)
        else:
            gray = self.convertGrayscale(fringe)
        self._setup(stereoRig, gray, fringe.shape[:2][::-1], 1.0 / period,
                    _getCentralPeak(fringe.shape[1], period, shift),
                    stripeColor, stripeSensitivity)

    def _setup(self, stereoRig, fringe_gray, fringeDims, fp, central_peak,
               stripeColor, stripeSensitivity):
        """State that follows from the rig and the grayscaled fringe."""
        self.stereoRig = stereoRig
        self.fringe = fringe_gray
        self.fringeDims = tuple(fringeDims)
        # Row-invariant fringe (every grayscale row identical, true for
        # buildFringe patterns) unlocks the 1-D virtual-reference resample
        # (warp.remap_row_invariant).
        fg = np.asarray(self.fringe)
        self._fringe_row_inv = bool(
            fg.ndim == 2 and np.array_equal(
                fg, np.broadcast_to(fg[0:1], fg.shape)))
        self.fp = fp
        self.stripeColor = stripeColor
        self.stripeSensitivity = stripeSensitivity
        self.stripeCentralPeak = central_peak
        self.F = np.asarray(stereoRig.getFundamentalMatrix(), np.float64)
        self.Rectify1, self.Rectify2, commonR = \
            rectification._lowLevelRectify(stereoRig)
        # epipole on the projector: camera center projected to it
        ep = np.asarray(stereoRig.intrinsic2, np.float64) @ \
            np.asarray(stereoRig.T, np.float64).reshape(3, 1)
        self.ep = (ep / ep[2]).ravel()
        R_inv = np.eye(4)
        R_inv[:3, :3] = np.linalg.inv(commonR)
        self.R_inv = R_inv

    @staticmethod
    def convertGrayscale(img):
        """Max over channels: keeps the stripe white (active.py:404-429)."""
        img = np.asarray(img)
        if img.ndim == 2:
            return img.astype(np.float64)
        return np.max(img, axis=2).astype(np.float64)

    @staticmethod
    def convertGrayscaleDevice(img):
        """Device twin of :meth:`convertGrayscale` (torch, stays on the
        tensor's device)."""
        if img.dim() == 2:
            return img.to(torch.float32)
        return img.amax(dim=2).to(torch.float32)

    # -- internals ---------------------------------------------------------

    def _grayscale_plan(self):
        """Which grayscale hook governs the fused path.

        The fused pipeline's fast path keys off the static ``_GRAY_MODE``
        string. A subclass may instead override :meth:`convertGrayscale`
        (the reference's documented customization point) and/or its
        device twin :meth:`convertGrayscaleDevice` WITHOUT declaring a
        matching ``_GRAY_MODE``; both overrides must be honored. Returns:

        - ``"mode"``: ``_GRAY_MODE`` is declared at least as deep in the
          MRO as any function override: use the fast fused branch;
        - ``"device"``: ``convertGrayscaleDevice`` is the deepest
          override: apply it on the device and feed the 2-D frame in;
        - ``"host"``: only ``convertGrayscale`` is overridden: apply it
          on the host.
        """
        mro = type(self).__mro__

        def depth(name):
            for i, c in enumerate(mro):
                if name in c.__dict__:
                    return i
            return len(mro)

        dm = depth("_GRAY_MODE")
        ddev = depth("convertGrayscaleDevice")
        dhost = depth("convertGrayscale")
        if dm <= min(ddev, dhost):
            return "mode"
        return "device" if ddev <= dhost else "host"

    def _customGrayscale(self):
        """True when a grayscale override bypasses the ``_GRAY_MODE``
        fast path (see :meth:`_grayscale_plan`)."""
        return self._grayscale_plan() != "mode"

    def _rig_tensors(self):
        """The rig's float32 constants of the dense pipeline, on the
        device."""
        rig, dev = self.stereoRig, self.device
        M = (np.asarray(rig.R, np.float64)
             @ np.linalg.inv(np.asarray(rig.intrinsic1, np.float64)))
        return dict(
            M=_f32(M, dev), T=_f32(np.asarray(rig.T, np.float64).ravel(), dev),
            K2=_f32(rig.intrinsic2, dev), dist2=rig.distCoeffs2,
            fringe_gray=_f32(self.fringe, dev),
            peak=torch.tensor(self.stripeCentralPeak, dtype=torch.float32,
                              device=dev),
            fp=torch.tensor(self.fp, dtype=torch.float32, device=dev),
            ep=_f32(self.ep, dev), Rect1=self.Rectify1, Rect2=self.Rectify2,
            R_inv3=self.R_inv[:3, :3],
            baseline=torch.tensor(rig.getBaseline(), dtype=torch.float32,
                                  device=dev))

    def _getProjectorMapping(self, z):
        """(h, w, 2) projector coordinates and (h, w) virtual reference of
        the plane at depth z, on the device."""
        t = self._rig_tensors()
        pc, vr = _projector_mapping(
            torch.tensor([z], dtype=torch.float32, device=self.device),
            t["M"], t["T"], t["K2"], t["dist2"], t["fringe_gray"],
            tuple(self.stereoRig.res1), self._fringe_row_inv)
        return pc[0], vr[0]

    def _calculateCameraFrequency(self, objPoints):
        """Per-point carrier frequency on the camera (active.py:495-559)."""
        rig = self.stereoRig
        Ac = np.asarray(rig.intrinsic1, np.float64)
        Dc = rig.distCoeffs1
        Ap = np.asarray(rig.intrinsic2, np.float64)
        R = np.asarray(rig.R, np.float64)
        T = np.asarray(rig.T, np.float64).reshape(3, 1)
        Dp = rig.distCoeffs2

        Op = (-np.linalg.inv(R) @ T).ravel()
        objPoints = np.asarray(objPoints, np.float64).reshape(-1, 3)
        n = len(objPoints)

        pCenter = npgeom.project_points(
            objPoints, npgeom.matrix_to_rodrigues(R), T.ravel(), Ap, Dp)
        half = (1.0 / self.fp) / 2.0
        pts = np.vstack([
            np.stack([pCenter[:, 0] - half, pCenter[:, 1]], 1),
            np.stack([pCenter[:, 0] + half, pCenter[:, 1]], 1)])
        # "undistort" = apply inverse-pinhole projector optics
        pts = npgeom.undistort_points(pts, Ap, Dp, P=Ap)
        invARp = np.linalg.inv(Ap @ R)
        pp = np.hstack([pts, np.ones((2 * n, 1))])
        z = np.tile(objPoints[:, 2].reshape(-1, 1), (2, 1))
        hvec = (invARp @ pp.T).T
        s = (z - Op[2]) / hvec[:, [2]]
        pw = s * hvec + Op.reshape(1, 3)
        pc = npgeom.project_points(
            pw, np.zeros(3), np.zeros(3), Ac, Dc)
        a, b = pc[:n], pc[n:]
        Tc = (((a[:, 0] - b[:, 0]) ** 2 + (a[:, 1] - b[:, 1]) ** 2)
              / np.abs(a[:, 0] - b[:, 0]))
        return 1.0 / Tc

    def _triangulate(self, camPoints, p_x, roi):
        """Stripe triangulation via the epipolar line (active.py:561-605)."""
        rig = self.stereoRig
        camPoints = np.asarray(camPoints, np.float64).reshape(-1, 2).copy()
        n = len(camPoints)
        camPoints[:, 0] += roi[0]
        camPoints[:, 1] += roi[1]
        lines = np.hstack([camPoints, np.ones((n, 1))]) @ self.F.T
        if np.isscalar(p_x):
            p_x = np.full(n, float(p_x))
        p_x = np.asarray(p_x, np.float64).ravel()
        p_y = -(lines[:, 0] * p_x + lines[:, 2]) / lines[:, 1]
        projPoints = np.stack([p_x, p_y], 1)

        pc = npgeom.perspective_transform(camPoints, self.Rectify1)
        pp = npgeom.undistort_points(
            projPoints, rig.intrinsic2, rig.distCoeffs2, P=rig.intrinsic2)
        pp = npgeom.perspective_transform(pp, self.Rectify2)
        disparity = np.abs(pp[:, [0]] - pc[:, [0]])
        pc = np.hstack([pc, np.ones((n, 1))])
        pw = rig.getBaseline() * (pc / np.where(disparity > 1e-12,
                                                disparity, np.nan))
        return npgeom.perspective_transform(
            pw.reshape(-1, 1, 3), self.R_inv).reshape(-1, 3)

    def _check_stripe_params(self):
        if not 0 <= self.stripeSensitivity <= 1:
            raise ValueError("Threshold must be in the interval [0,1]!")
        if self.stripeColor not in _CHANNEL:
            raise ValueError("Color value not permitted!")

    def _undistort_centroids(self, imgs, roi):
        """Upload a (B, H, W, 3) numpy stack, undistort, crop and reduce
        the stripe on the device; the (B, rh) centroids come back."""
        rig = self.stereoRig
        dt = np.dtype(imgs.dtype)
        max_value = np.iinfo(dt).max if dt.kind in "iu" else 1.0
        und, cents = _prep_undistort_centroids(
            torch.tensor(imgs, device=self.device), rig.intrinsic1,
            None if rig.distCoeffs1 is None
            else np.asarray(rig.distCoeffs1, np.float64).ravel(),
            torch.tensor(max_value * self.stripeSensitivity,
                         dtype=torch.float32, device=self.device),
            roi=tuple(int(v) for v in roi),
            channel=_CHANNEL[self.stripeColor])
        return und, cents.cpu().numpy().astype(np.float64)

    def _stripe_plane(self, cents, roi, frame=None):
        """Host control plane of one frame: stripe fill, its triangulation,
        the reference-plane depth and the per-row carrier frequency.
        Returns (stripe indices (rh, 2) int64, z, fc)."""
        stripe_cam = _centroids_to_stripe(cents, int(roi[3]))
        if stripe_cam is None:
            where = "" if frame is None else f" {frame}"
            raise ValueError(f"Central stripe not found in image{where}!")
        stripe_cam = stripe_cam.reshape(-1, 2)
        stripe_idx = np.ceil(stripe_cam - 0.5).astype(np.int64)
        stripe_world = self._triangulate(
            stripe_cam.copy(), self.stripeCentralPeak, roi)
        z_plane = float(np.nanmean(stripe_world[:, 2]))
        return stripe_idx, z_plane, self._calculateCameraFrequency(
            stripe_world)

    # -- main entry --------------------------------------------------------

    def _cloud_prep(self, imgObj, radius_factor, roi):
        """Host preamble of :meth:`getCloud`: undistort, ROI crop,
        central-stripe carrier estimation, grayscale plan. Returns a dict
        of everything the fused device pipeline needs."""
        imgObj = np.asarray(imgObj)
        if imgObj.ndim != 3:
            raise ValueError("image must be a BGR color image!")
        self._check_stripe_params()
        rig = self.stereoRig
        widthC, heightC = rig.res1
        if roi is None:
            roi = (0, 0, widthC, heightC)
        und, cents = self._undistort_centroids(imgObj[None], roi)
        img = und[0]
        stripe_idx, z_plane, fc = self._stripe_plane(cents[0], roi)
        radius = radius_factor * fc

        # A subclass with a custom grayscale (the reference's documented
        # customization point): honor it by converting up front (device
        # twin preferred, host otherwise) and feeding the 2-D frame in.
        plan = self._grayscale_plan()
        if plan == "device":
            gray_mode = "host"  # the fused path takes the 2-D frame as is
            img = self.convertGrayscaleDevice(img).to(torch.float32)
        elif plan == "host":
            gray_mode = "host"
            img = _f32(self.convertGrayscale(img.cpu().numpy()), self.device)
        else:
            gray_mode = self._GRAY_MODE
        return dict(imgObj=img, roi=roi, stripe_idx=stripe_idx,
                    z_plane=z_plane, fc=fc, radius=radius,
                    gray_mode=gray_mode)

    def getCloud(self, imgObj, radius_factor=0.5, roi=None,
                 unwrappingMethod=None, plot=False, dump=None,
                 out_dtype=None):
        """Process one camera image into a point cloud (roi_h, roi_w, 3)
        (reference active.py:608-841).

        Debug introspection (the reference's ``plot=True`` spectrum/phase
        windows): pass a dict as ``dump`` to receive the row-FFT magnitude
        spectra of the object and virtual-reference frames, the wrapped
        and unwrapped phase maps, the per-row band edges and the fringe
        order k; ``plot=True`` shows the same panels, ``plot="path.png"``
        saves them (headless).

        unwrappingMethod : optional callable, numpy phase -> unwrapped
            phase (e.g. ``lambda p: unwrapping.infiniteImpulseResponse(p,
            0.5)``). Default: :func:`unwrapping.unwrap2D` on the device.

        out_dtype : optional numpy dtype for the returned cloud. Default
            (None) keeps the reference's float64; ``np.float16`` halves
            the device-to-host transfer by casting on the device.
        """
        debug = bool(plot) or dump is not None
        prep = self._cloud_prep(imgObj, radius_factor, roi)
        img, roi = prep["imgObj"], prep["roi"]
        stripe_idx, z_plane = prep["stripe_idx"], prep["z_plane"]
        fc, radius = prep["fc"], prep["radius"]
        roi_x, roi_y, roi_w, roi_h = roi
        t = self._rig_tensors()
        dev = self.device

        if unwrappingMethod is None:
            out = _ftp_cloud_fused(
                img[None], torch.tensor([z_plane], dtype=torch.float32,
                                        device=dev),
                t["M"], t["T"], t["K2"], t["dist2"], t["fringe_gray"],
                _f32(fc - radius, dev)[None], _f32(fc + radius, dev)[None],
                torch.as_tensor(stripe_idx, device=dev)[None], t["peak"],
                t["fp"], t["ep"], t["Rect1"], t["Rect2"], t["R_inv3"],
                t["baseline"], res=tuple(self.stereoRig.res1),
                roi=tuple(int(v) for v in roi), gray_mode=prep["gray_mode"],
                debug=debug, row_inv=self._fringe_row_inv)
            cloud, dbg = out if debug else (out, None)
            if debug:
                dbg = {kk: v[0].cpu().numpy() for kk, v in dbg.items()}
                dbg["fmin"] = np.asarray(fc - radius)
                dbg["fmax"] = np.asarray(fc + radius)
                if dump is not None:
                    dump.update(dbg)
                if plot:
                    _render_ftp_debug(dbg, plot)
            return _cloud_out(cloud[0], out_dtype)

        # custom unwrapping callback: staged path with a host round trip
        imgObj_gray = self.convertGrayscaleDevice(img)
        projCoords, imgR_gray = self._getProjectorMapping(z_plane)
        imgR_gray = imgR_gray[roi_y:roi_y + roi_h, roi_x:roi_x + roi_w]
        projCoords = projCoords[roi_y:roi_y + roi_h, roi_x:roi_x + roi_w]

        phase = _phase_pipeline(imgObj_gray.to(torch.float32), imgR_gray,
                                _f32(fc - radius, dev), _f32(fc + radius, dev))
        phase_np = phase.cpu().numpy()
        unwrapped = unwrappingMethod(phase_np)
        if isinstance(unwrapped, torch.Tensor):
            unwrapped = unwrapped.cpu().numpy()
        phaseUnwrapped = _f32(unwrapped, dev)

        # integer fringe order k from the stripe (active.py:779-791):
        # small gathers, then host scalars
        sy = _index(torch.as_tensor(stripe_idx[:, 1], device=dev), roi_h)
        sx = _index(torch.as_tensor(stripe_idx[:, 0], device=dev), roi_w)
        theta = phaseUnwrapped[sy, sx].cpu().numpy().astype(np.float64)
        u_A = projCoords[sy, sx, 0].cpu().numpy().astype(np.float64)
        k = (self.stripeCentralPeak - u_A) * self.fp - theta / (2 * np.pi)
        k = float(np.ceil(np.mean(k) - 0.5))

        if debug:
            dbg = dict(
                spectrum=np.abs(np.fft.fft(imgObj_gray.cpu().numpy(),
                                           axis=1)),
                spectrum_ref=np.abs(np.fft.fft(imgR_gray.cpu().numpy(),
                                               axis=1)),
                phase=phase_np, phase_unwrapped=np.asarray(unwrapped),
                k=np.float32(k), fmin=np.asarray(fc - radius),
                fmax=np.asarray(fc + radius))
            if dump is not None:
                dump.update(dbg)
            if plot:
                _render_ftp_debug(dbg, plot)

        cloud = _dense_cloud(
            projCoords[None], phaseUnwrapped[None],
            torch.tensor([k], dtype=torch.float32, device=dev), t["ep"],
            t["fp"], t["K2"], t["dist2"], t["Rect1"], t["Rect2"],
            t["R_inv3"], t["baseline"], roi_x,
            torch.tensor(float(roi_y), dtype=torch.float32, device=dev))
        return _cloud_out(cloud[0], out_dtype)

    def getCloudBatch(self, imgs, radius_factor=0.5, roi=None,
                      out_dtype=None):
        """Throughput form of :meth:`getCloud`: a (B, H, W, 3) capture
        stack -> (B, roi_h, roi_w, 3) clouds.

        The dense work of the whole stack runs batched on the device
        (undistortion + stripe centroids, then the fused pipeline); the
        per-frame host control plane (stripe fill, triangulation, carrier
        frequency) runs between them.
        """
        imgs = np.asarray(imgs)
        if imgs.ndim != 4 or imgs.shape[-1] != 3:
            raise ValueError("imgs must be a (B, H, W, 3) BGR stack!")
        self._check_stripe_params()
        if isinstance(self, StereoFTP_Mapping):
            # the classic no-virtual-reference pipeline: running the base
            # fused pipeline here would triangulate the wrong geometry
            raise TypeError(
                "StereoFTP_Mapping uses the classic no-virtual-reference "
                "pipeline; getCloudBatch covers StereoFTP/"
                "StereoFTPAnaglyph: loop getCloud per frame instead")
        if self._customGrayscale():
            # custom-grayscale subclasses take the per-frame path (their
            # hooks are functions of a single frame)
            return np.stack([
                self.getCloud(im, radius_factor=radius_factor, roi=roi,
                              out_dtype=out_dtype) for im in imgs])
        rig = self.stereoRig
        widthC, heightC = rig.res1
        if roi is None:
            roi = (0, 0, widthC, heightC)
        und, cents = self._undistort_centroids(imgs, roi)

        zs, fmins, fmaxs, sidxs = [], [], [], []
        for b in range(imgs.shape[0]):
            sidx, z, fc = self._stripe_plane(cents[b], roi, frame=b)
            radius = radius_factor * fc
            zs.append(z)
            sidxs.append(sidx)
            fmins.append(fc - radius)
            fmaxs.append(fc + radius)

        t = self._rig_tensors()
        dev = self.device
        clouds = _ftp_cloud_fused(
            und, torch.tensor(zs, dtype=torch.float32, device=dev),
            t["M"], t["T"], t["K2"], t["dist2"], t["fringe_gray"],
            _f32(np.stack(fmins), dev), _f32(np.stack(fmaxs), dev),
            torch.as_tensor(np.stack(sidxs), device=dev), t["peak"], t["fp"],
            t["ep"], t["Rect1"], t["Rect2"], t["R_inv3"], t["baseline"],
            res=tuple(rig.res1), roi=tuple(int(v) for v in roi),
            gray_mode=self._GRAY_MODE, row_inv=self._fringe_row_inv)
        return _cloud_out(clouds, out_dtype)


def _cloud_out(cloud, out_dtype):
    """A float32 cloud tensor as numpy: float64 by default, else
    ``out_dtype`` (cast on the device, before the transfer)."""
    if out_dtype is not None:
        return cloud.to(_torch_dtype(out_dtype)).cpu().numpy()
    return cloud.cpu().numpy().astype(np.float64)


class StereoFTPAnaglyph(StereoFTP):
    """FTP with the anaglyph fringe of :func:`buildAnaglyphFringe`
    (reference active.py:844-1128): grayscale is the normalized B - R
    difference [Guo 1990], which suppresses the DC term."""

    _GRAY_MODE = "br"

    @staticmethod
    def convertGrayscale(img):
        img = np.asarray(img)
        if img.ndim == 2:
            return img.astype(np.float64)
        d = img[:, :, 0].astype(np.float64) - img[:, :, 2].astype(np.float64)
        ptp = np.ptp(d)
        return (d - d.min()) / (ptp if ptp > 0 else 1.0)

    @staticmethod
    def convertGrayscaleDevice(img):
        if img.dim() == 2:
            return img.to(torch.float32)
        return _gray_frames(img[None], "br")[0]


class StereoFTP_Mapping(StereoFTP):
    """Classic (no virtual reference) FTP mapping variant (reference
    active.py:1266-1450): band-passes the object image only, derives the
    absolute phase offset from the stripe, and maps phase directly to
    projector x coordinates. Host numpy after the undistortion, as in the
    JAX package."""

    def getCloud(self, imgObj, radius_factor=0.5, roi=None,
                 unwrappingMethod=None, plot=False, dump=None,
                 out_dtype=None):
        imgObj = np.asarray(imgObj)
        if imgObj.ndim != 3:
            raise ValueError("image must be a BGR color image!")
        rig = self.stereoRig
        widthC, heightC = rig.res1
        debug = bool(plot) or dump is not None
        imgObj = warp.undistort_image(
            torch.tensor(imgObj, device=self.device), rig.intrinsic1,
            rig.distCoeffs1).cpu().numpy()
        if roi is not None:
            roi_x, roi_y, roi_w, roi_h = roi
            imgObj = imgObj[roi_y:roi_y + roi_h, roi_x:roi_x + roi_w]
        else:
            roi = (0, 0, widthC, heightC)
            roi_x, roi_y, roi_w, roi_h = roi

        stripe_cam = findCentralStripe(imgObj, self.stripeColor,
                                       self.stripeSensitivity)
        if stripe_cam is None:
            raise ValueError("Central stripe not found in image!")
        stripe_cam = stripe_cam.reshape(-1, 2)
        stripe_idx = np.ceil(stripe_cam - 0.5).astype(np.int64)
        stripe_world = self._triangulate(
            stripe_cam.copy(), self.stripeCentralPeak, roi)
        fc = self._calculateCameraFrequency(stripe_world)

        imgObj_gray = self.convertGrayscale(imgObj)
        # object-only band-pass: the reference phase is the pure carrier
        radius = radius_factor * fc
        G = np.fft.fft(imgObj_gray, axis=1)
        spectrum = np.abs(G) if debug else None
        freqs = np.fft.fftfreq(roi_w)
        keep = ((freqs[None, :] - (fc - radius)[:, None] >= 0)
                & (freqs[None, :] - (fc + radius)[:, None] <= 0))
        G[~keep] = 0
        ghat = np.fft.ifft(G, axis=1)
        phase_w = np.angle(ghat)
        if unwrappingMethod is None:
            phase = np.unwrap(phase_w, axis=1)
            phase = np.unwrap(phase, axis=0)
        else:
            phase = np.asarray(unwrappingMethod(phase_w))
        if debug:
            dbg = dict(spectrum=spectrum, phase=phase_w,
                       phase_unwrapped=phase, fmin=fc - radius,
                       fmax=fc + radius)
            if dump is not None:
                dump.update(dbg)
            if plot:
                _render_ftp_debug(dbg, plot)

        # absolute phase via the mean phase at the stripe
        theta = phase[stripe_idx[:, 1], stripe_idx[:, 0]]
        phase = phase - np.mean(theta)
        # projector x coordinate from phase (active.py:1441)
        Xp = phase.reshape(-1, 1) / (2 * np.pi * self.fp) \
            + self.stripeCentralPeak

        gx, gy = np.meshgrid(np.arange(roi_w), np.arange(roi_h))
        cam = np.stack([gx, gy], -1).reshape(-1, 2).astype(np.float64) + 0.5
        pts = self._triangulate(cam, Xp.ravel(), roi)
        pts = pts.reshape(roi_h, roi_w, 3)
        # keep the base-class getCloud contract (polymorphic callers)
        return pts if out_dtype is None else pts.astype(out_dtype)


class StereoFTP_PhaseOnly(StereoFTP):
    """Phase-map-only variant (reference active.py:1703-2074, experimental
    there): the same pipeline as :class:`StereoFTP` up to the unwrapping,
    returning the phase map."""

    def getPhase(self, imgObj, radius_factor=0.5, roi=None,
                 unwrappingMethod=None, plot=False):
        imgObj = np.asarray(imgObj)
        if imgObj.ndim != 3:
            raise ValueError("image must be a BGR color image!")
        rig = self.stereoRig
        widthC, heightC = rig.res1
        imgObj = warp.undistort_image(
            torch.tensor(imgObj, device=self.device), rig.intrinsic1,
            rig.distCoeffs1).cpu().numpy()
        if roi is not None:
            roi_x, roi_y, roi_w, roi_h = roi
            imgObj = imgObj[roi_y:roi_y + roi_h, roi_x:roi_x + roi_w]
        else:
            roi = (0, 0, widthC, heightC)
            roi_x, roi_y, roi_w, roi_h = roi

        stripe_cam = findCentralStripe(imgObj, self.stripeColor,
                                       self.stripeSensitivity)
        if stripe_cam is None:
            raise ValueError("Central stripe not found in image!")
        stripe_world = self._triangulate(
            stripe_cam.reshape(-1, 2).copy(), self.stripeCentralPeak, roi)
        z_plane = float(np.nanmean(stripe_world[:, 2]))
        fc = self._calculateCameraFrequency(stripe_world)

        projCoords, imgR_gray = self._getProjectorMapping(z_plane)
        imgR_gray = imgR_gray[roi_y:roi_y + roi_h, roi_x:roi_x + roi_w]
        imgObj_gray = self.convertGrayscale(imgObj)
        radius = radius_factor * fc
        phase = _phase_pipeline(_f32(imgObj_gray, self.device), imgR_gray,
                                _f32(fc - radius, self.device),
                                _f32(fc + radius, self.device))
        if unwrappingMethod is None:
            return _unwrap2d(phase).cpu().numpy()
        return unwrappingMethod(phase.cpu().numpy())
