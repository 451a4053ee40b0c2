"""
rigs
====

Stereo rig data model: :class:`StereoRig`, :class:`RectifiedStereoRig` and
:class:`StructuredLightRig`, the port of :mod:`simplestereo_tpu.rigs`.

The JSON schema is the JAX package's and the reference's (keys ``res1,
res2, intrinsic1, intrinsic2, R, T, distCoeffs1, distCoeffs2 [, F, E,
reprojectionError]`` plus ``Rcommon, rectHomography1, rectHomography2`` for
rectified rigs), so a rig saved by either package loads in the other.

Rig state is host-side numpy float64, as in the JAX package. Each rig also
has a ``device`` (keyword-only, default ``"cuda"``, resolved by
:func:`~simplestereo_tpu_torch.resolve_device`): the image-size work
(rectification maps, ``rectifyImages``, ``undistortImages``,
``get3DPoints``) runs there, with numpy in and numpy out.
"""

import json

import numpy as np
import torch

from . import points
from . import utils
from . import warp
from ._device import resolve_device
from .geometry import npgeom


class StereoRig:
    """Container for all parameters of a calibrated two-view rig.

    ``res1``/``res2`` are (width, height); ``intrinsic1``/``intrinsic2``
    3x3; ``distCoeffs*`` of length 0/4/5/8/12/14 (default zeros(5));
    ``R``/``T`` map camera-1 coordinates into camera-2 (world origin in
    camera 1); optional ``E``, ``F`` and calibration
    ``reprojectionError``. ``device`` is where its image operations run.
    """

    def __init__(self, res1, res2, intrinsic1, intrinsic2, distCoeffs1,
                 distCoeffs2, R, T, F=None, E=None, reprojectionError=None,
                 *, device="cuda"):
        self.device = resolve_device(device)
        self.res1 = tuple(res1)
        self.res2 = tuple(res2)
        self.intrinsic1 = intrinsic1
        self.intrinsic2 = intrinsic2
        self.distCoeffs1 = distCoeffs1
        self.distCoeffs2 = distCoeffs2
        self.R = R
        self.T = T
        self.F = F
        self.E = E
        self.reprojectionError = reprojectionError

    # -- coercing properties -----------------------------------------------

    @property
    def intrinsic1(self):
        return self._intrinsic1

    @intrinsic1.setter
    def intrinsic1(self, v):
        self._intrinsic1 = np.asarray(v, np.float64).reshape(3, 3)

    @property
    def intrinsic2(self):
        return self._intrinsic2

    @intrinsic2.setter
    def intrinsic2(self, v):
        self._intrinsic2 = np.asarray(v, np.float64).reshape(3, 3)

    @property
    def distCoeffs1(self):
        return self._distCoeffs1

    @distCoeffs1.setter
    def distCoeffs1(self, d):
        self._distCoeffs1 = np.asarray(d, np.float64).ravel() if d is not None else np.zeros(5)

    @property
    def distCoeffs2(self):
        return self._distCoeffs2

    @distCoeffs2.setter
    def distCoeffs2(self, d):
        self._distCoeffs2 = np.asarray(d, np.float64).ravel() if d is not None else np.zeros(5)

    @property
    def R(self):
        return self._R

    @R.setter
    def R(self, v):
        self._R = np.asarray(v, np.float64).reshape(3, 3)

    @property
    def T(self):
        return self._T

    @T.setter
    def T(self, v):
        self._T = np.asarray(v, np.float64).reshape(-1, 1)

    @property
    def F(self):
        return self._F

    @F.setter
    def F(self, v):
        self._F = np.asarray(v, np.float64).reshape(3, 3) if v is not None else None

    @property
    def E(self):
        return self._E

    @E.setter
    def E(self, v):
        self._E = np.asarray(v, np.float64).reshape(3, 3) if v is not None else None

    # -- persistence ---------------------------------------------------------

    @classmethod
    def fromFile(cls, filepath, *, device="cuda"):
        """Load a rig from the reference-compatible JSON schema."""
        with open(filepath, "r") as f:
            data = json.load(f)
        return cls(
            tuple(data.get("res1")),
            tuple(data.get("res2")),
            data.get("intrinsic1"),
            data.get("intrinsic2"),
            data.get("distCoeffs1"),
            data.get("distCoeffs2"),
            data.get("R"),
            data.get("T"),
            data.get("F"),
            data.get("E"),
            data.get("reprojectionError"),
            device=device,
        )

    def _state_dict(self):
        out = {}
        out["res1"] = list(self.res1)
        out["res2"] = list(self.res2)
        out["intrinsic1"] = self.intrinsic1.tolist()
        out["intrinsic2"] = self.intrinsic2.tolist()
        out["R"] = self.R.tolist()
        out["T"] = self.T.tolist()
        out["distCoeffs1"] = self.distCoeffs1.tolist()
        out["distCoeffs2"] = self.distCoeffs2.tolist()
        if self.F is not None:
            out["F"] = self.F.tolist()
        if self.E is not None:
            out["E"] = self.E.tolist()
        if self.reprojectionError:
            out["reprojectionError"] = float(self.reprojectionError)
        return out

    def save(self, filepath):
        """Save to the reference-compatible JSON schema."""
        with open(filepath, "w") as f:
            json.dump(self._state_dict(), f, indent=4)

    # -- derived geometry ----------------------------------------------------

    def getCenters(self):
        """Camera centers in world coordinates (camera 1 is the origin)."""
        Po1, Po2 = self.getProjectionMatrices()
        C1 = np.zeros(3)
        C2 = -np.linalg.inv(Po2[:, :3]) @ Po2[:, 3]
        return C1, C2

    def getBaseline(self):
        """Norm of the vector from camera 1 to camera 2."""
        _, C2 = self.getCenters()
        return float(np.linalg.norm(C2))

    def getProjectionMatrices(self):
        """3x4 projection matrices P1 = [K1|0], P2 = K2 [R|T]."""
        Po1 = np.hstack((self.intrinsic1, np.zeros((3, 1))))
        Po2 = self.intrinsic2 @ np.hstack((self.R, self.T))
        return Po1, Po2

    def getFundamentalMatrix(self):
        """Fundamental matrix; computed on demand if not set.

        Uses the Hartley-Zisserman composition
        ``F = K2^-T R K1^T [K1 R^T T]_x``, as the reference does.
        """
        if self.F is None:
            vv = utils.getCrossProductMatrix(self.intrinsic1 @ self.R.T @ self.T)
            self.F = np.linalg.inv(self.intrinsic2).T @ self.R @ self.intrinsic1.T @ vv
        return self.F

    def getEssentialMatrix(self):
        """Essential matrix E = K2^T F K1; computed on demand if not set."""
        if self.E is None:
            F = self.getFundamentalMatrix()
            self.E = self.intrinsic2.T @ F @ self.intrinsic1
        return self.E

    def _tensor(self, img):
        """A numpy image as a tensor on the rig's device."""
        return torch.tensor(np.asarray(img), device=self.device)

    def undistortImages(self, img1, img2, changeCameras=False, alpha=1,
                        destDims=None, centerPrincipalPoint=False):
        """Undistort an image pair on the rig's device (numpy in and out).

        Equivalent of the reference's ``cv2.getOptimalNewCameraMatrix`` +
        ``cv2.undistort``, including the arity quirk: with
        ``changeCameras=True`` the two new camera matrices are returned too.
        """
        t1, t2 = self._tensor(img1), self._tensor(img2)
        if changeCameras:
            K1new, _ = warp.get_optimal_new_camera_matrix(
                self.intrinsic1, self.distCoeffs1, self.res1, alpha, destDims,
                centerPrincipalPoint)
            K2new, _ = warp.get_optimal_new_camera_matrix(
                self.intrinsic2, self.distCoeffs2, self.res2, alpha, destDims,
                centerPrincipalPoint)
            u1 = warp.undistort_image(t1, self.intrinsic1, self.distCoeffs1, K1new)
            u2 = warp.undistort_image(t2, self.intrinsic2, self.distCoeffs2, K2new)
            return u1.cpu().numpy(), u2.cpu().numpy(), K1new, K2new
        u1 = warp.undistort_image(t1, self.intrinsic1, self.distCoeffs1)
        u2 = warp.undistort_image(t2, self.intrinsic2, self.distCoeffs2)
        return u1.cpu().numpy(), u2.cpu().numpy()


class RectifiedStereoRig(StereoRig):
    """A calibrated rig plus pixel-domain rectifying homographies.

    ``RectifiedStereoRig(Rcommon, H1, H2, rig)`` takes ``rig.device``
    unless ``device`` is given; built from the plain parameters it defaults
    to ``"cuda"``. The stored transforms are the literature's *image
    homographies*, not OpenCV's object-space rotations; ``K1``/``K2``
    accumulate every affine applied after rectification and are what 3D
    reconstruction must use. The rectification maps are built at once, on
    the rig's device.
    """

    def __init__(self, Rcommon, rectHomography1, rectHomography2, *args,
                 device=None):
        self.Rcommon = Rcommon
        self.rectHomography1 = rectHomography1
        self.rectHomography2 = rectHomography2
        self.K1 = None
        self.K2 = None

        if isinstance(args[0], StereoRig):
            r = args[0]
            super().__init__(r.res1, r.res2, r.intrinsic1, r.intrinsic2,
                             r.distCoeffs1, r.distCoeffs2, r.R, r.T, r.F, r.E,
                             r.reprojectionError,
                             device=r.device if device is None else device)
        else:
            super().__init__(*args,
                             device="cuda" if device is None else device)

        self.computeRectificationMaps()

    @property
    def Rcommon(self):
        return self._Rcommon

    @Rcommon.setter
    def Rcommon(self, v):
        self._Rcommon = np.asarray(v, np.float64).reshape(3, 3)

    @property
    def rectHomography1(self):
        return self._rectHomography1

    @rectHomography1.setter
    def rectHomography1(self, v):
        self._rectHomography1 = np.asarray(v, np.float64).reshape(3, 3)

    @property
    def rectHomography2(self):
        return self._rectHomography2

    @rectHomography2.setter
    def rectHomography2(self, v):
        self._rectHomography2 = np.asarray(v, np.float64).reshape(3, 3)

    @classmethod
    def fromFile(cls, filepath, *, device="cuda"):
        """Load from the reference-compatible rectified-rig JSON schema."""
        with open(filepath, "r") as f:
            data = json.load(f)
        return cls(
            data.get("Rcommon"),
            data.get("rectHomography1"),
            data.get("rectHomography2"),
            data.get("res1"),
            data.get("res2"),
            data.get("intrinsic1"),
            data.get("intrinsic2"),
            data.get("distCoeffs1"),
            data.get("distCoeffs2"),
            data.get("R"),
            data.get("T"),
            data.get("F"),
            data.get("E"),
            data.get("reprojectionError"),
            device=device,
        )

    def save(self, filepath):
        """Save to the reference-compatible rectified-rig JSON schema."""
        out = {
            "Rcommon": self.Rcommon.tolist(),
            "rectHomography1": self.rectHomography1.tolist(),
            "rectHomography2": self.rectHomography2.tolist(),
        }
        out.update(self._state_dict())
        with open(filepath, "w") as f:
            json.dump(out, f, indent=4)

    def getRectifiedProjectionMatrices(self):
        """3x4 projection matrices after rectification (shared Rcommon)."""
        C1, C2 = self.getCenters()
        P1 = self.K1 @ self.Rcommon @ np.hstack((np.eye(3), -C1[:, None]))
        P2 = self.K2 @ self.Rcommon @ np.hstack((np.eye(3), -C2[:, None]))
        return P1, P2

    def computeRectificationMaps(self, destDims=None, alpha=1):
        """Build undistort+rectify maps fitted into ``destDims``.

        Computes the shared fitting affine, tracks the post-rectification
        intrinsics K1/K2 (normalized by K[2,2], as the JAX package does),
        and builds the four float32 sampling maps ``mapx1, mapy1, mapx2,
        mapy2`` as tensors on the rig's device.
        """
        from . import rectification as rect

        if destDims is None:
            destDims = self.res1

        Fit = rect.getFittingMatrix(
            self.intrinsic1, self.intrinsic2,
            self.rectHomography1, self.rectHomography2,
            self.res1, self.res2,
            self.distCoeffs1, self.distCoeffs2,
            destDims, alpha,
        )

        # All transforms applied after rectification — needed for 3D.
        K1 = Fit @ self.rectHomography1 @ self.intrinsic1 @ self.Rcommon.T
        K2 = Fit @ self.rectHomography2 @ (self.intrinsic2 @ self.R) @ self.Rcommon.T
        self.K1 = K1 / K1[2, 2]
        self.K2 = K2 / K2[2, 2]

        # Object-space rotations for map building.
        R1 = self.Rcommon
        R2 = self.Rcommon @ self.R.T

        self.mapx1, self.mapy1 = warp.init_undistort_rectify_map(
            self.intrinsic1, self.distCoeffs1, R1, self.K1, destDims,
            device=self.device)
        self.mapx2, self.mapy2 = warp.init_undistort_rectify_map(
            self.intrinsic2, self.distCoeffs2, R2, self.K2, destDims,
            device=self.device)

    def rectifyImages(self, img1, img2, interpolation="linear"):
        """Undistort + rectify + fit an image pair on the rig's device
        (numpy in, numpy out)."""
        r1 = warp.remap(self._tensor(img1), self.mapx1, self.mapy1,
                        interpolation=interpolation)
        r2 = warp.remap(self._tensor(img2), self.mapx2, self.mapy2,
                        interpolation=interpolation)
        return r1.cpu().numpy(), r2.cpu().numpy()

    def getQMatrix(self):
        """4x4 disparity-to-depth matrix for the rectified pair.

        Handles different cx between the two cameras and x-shear terms,
        exactly as the reference builds it.
        """
        b = self.getBaseline()
        fx = self.K1[0, 0]
        fy = self.K2[1, 1]
        cx1 = self.K1[0, 2]
        cx2 = self.K2[0, 2]
        a1 = self.K1[0, 1]
        a2 = self.K2[0, 1]
        cy = self.K1[1, 2]

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
        return Q

    def get3DPoints(self, disparityMap):
        """Reproject a dense disparity map to (H, W, 3) float32 numpy world
        points, on the rig's device."""
        return points.reprojectImageTo3D(disparityMap, self.getQMatrix(),
                                         device=self.device)


class StructuredLightRig(StereoRig):
    """Camera + projector rig with triangulation helpers.

    The projector is modeled as an inverse pinhole camera in position 2.
    Built from a :class:`StereoRig`, whose ``device`` it takes unless
    ``device`` is given.
    """

    def __init__(self, r, *, device=None):
        if not isinstance(r, StereoRig):
            raise ValueError("Invalid argument!")
        super().__init__(r.res1, r.res2, r.intrinsic1, r.intrinsic2,
                         r.distCoeffs1, r.distCoeffs2, r.R, r.T, r.F, r.E,
                         r.reprojectionError,
                         device=r.device if device is None else device)
        self._computeMatrices()

    def _computeMatrices(self):
        from . import rectification as rect
        self.R1, self.R2, self.Rcommon = rect._lowLevelRectify(self)
        R_inv = np.eye(4)
        R_inv[:3, :3] = np.linalg.inv(self.Rcommon)
        self.R_inv = R_inv

    @classmethod
    def fromFile(cls, filepath, *, device="cuda"):
        return cls(StereoRig.fromFile(filepath, device=device))

    def triangulate(self, camPoints, projPoints):
        """Triangulate camera-projector correspondences to 3D (host numpy).

        ``camPoints`` must already be undistorted; projector points get the
        "inverse pinhole" re-distortion treatment (undistort with the
        projector's coefficients through its own intrinsics), then both sets
        are rectified to the baseline frame and intersected by disparity
        scaling, as the reference does.

        Returns (N, 1, 3) world points in the camera frame.
        """
        pc = np.asarray(camPoints, np.float64).reshape(-1, 2)
        pp = np.asarray(projPoints, np.float64).reshape(-1, 2)

        pc = npgeom.perspective_transform(pc, self.R1)
        pc = np.hstack([pc, np.ones((pc.shape[0], 1))])

        pp = npgeom.undistort_points(
            pp, self.intrinsic2, self.distCoeffs2, P=self.intrinsic2)
        pp = npgeom.perspective_transform(pp, self.R2)

        disparity = np.abs(pp[:, [0]] - pc[:, [0]])
        # Zero disparity (point at infinity) yields inf coordinates, not a
        # crash — the reference divides unguarded.
        with np.errstate(divide="ignore", invalid="ignore"):
            finalPoints = self.getBaseline() * (pc / disparity)

        # Undo the common orientation to return to camera-1 coordinates.
        finalPoints = npgeom.perspective_transform(
            finalPoints.reshape(-1, 1, 3), self.R_inv)
        return finalPoints

    def undistortCameraImage(self, imgObj):
        """Undistort the camera image on the rig's device (numpy in, numpy
        out)."""
        return warp.undistort_image(
            self._tensor(imgObj), self.intrinsic1,
            self.distCoeffs1).cpu().numpy()
