"""
convert
=======

Build the port's objects from their JAX-package counterparts.

The matchers hold no learned weights: their whole state is their
constructor parameters (for SGM with P1 and P2 already resolved from
their defaults), so converting one is reading them. The JAX matchers'
engine choice (``aggregator``, ``engine``) has no counterpart: the
device decides. A rig's state is its float64 arrays, copied by
:func:`rig_from_jax`. A scanner's is its rig and parameters
(:func:`graycode_from_jax`, :func:`ftp_from_jax`). Attributes are read
with ``getattr``, so this module imports neither ``jax`` nor
``simplestereo_tpu``.
"""

import numpy as np

from ._device import resolve_device
from .passive import StereoASW, StereoGSW, StereoSGM

_ASW_PARAMS = ("winSize", "maxDisparity", "minDisparity", "gammaC", "gammaP",
               "consistent", "step", "subpixel")
_SGM_PARAMS = ("minDisparity", "numDisparities", "blockSize", "P1", "P2",
               "disp12MaxDiff", "preFilterCap", "uniquenessRatio",
               "speckleWindowSize", "speckleRange", "paths", "costMethod",
               "censusWindow")
_GSW_PARAMS = ("winSize", "maxDisparity", "minDisparity", "gamma", "fMax",
               "iterations", "bins", "consistent", "costMethod",
               "miIterations", "normalize", "step")


def asw_from_jax(matcher, device="cuda"):
    """Port's :class:`StereoASW` computing what ``matcher`` (a
    ``simplestereo_tpu.passive.StereoASW``) computes, on ``device``."""
    return StereoASW(**{k: getattr(matcher, k) for k in _ASW_PARAMS},
                     device=device)


def sgm_from_jax(matcher, device="cuda"):
    """Port's :class:`StereoSGM` computing what ``matcher`` (a
    ``simplestereo_tpu.passive.StereoSGM``) computes, on ``device``."""
    return StereoSGM(**{k: getattr(matcher, k) for k in _SGM_PARAMS},
                     device=device)


def gsw_from_jax(matcher, device="cuda"):
    """Port's :class:`StereoGSW` computing what ``matcher`` (a
    ``simplestereo_tpu.passive.StereoGSW``) computes, on ``device``."""
    return StereoGSW(**{k: getattr(matcher, k) for k in _GSW_PARAMS},
                     device=device)


_RIG_PARAMS = ("res1", "res2", "intrinsic1", "intrinsic2", "distCoeffs1",
               "distCoeffs2", "R", "T", "F", "E", "reprojectionError")
_RECT_PARAMS = ("Rcommon", "rectHomography1", "rectHomography2")


def rig_from_jax(rig, device="cuda"):
    """Port's rig holding what ``rig`` (a ``simplestereo_tpu`` StereoRig,
    RectifiedStereoRig or StructuredLightRig) holds, on ``device``.

    The float64 arrays are copied. A rectified rig keeps its homographies
    and ``Rcommon`` and rebuilds its maps on ``device``; a structured-light
    rig recomputes its rectifying transforms from the same parameters.
    """
    from .rigs import RectifiedStereoRig, StereoRig, StructuredLightRig

    def copy(v):
        return None if v is None else np.array(v, np.float64)

    params = [getattr(rig, k) for k in _RIG_PARAMS]
    params[2:10] = [copy(v) for v in params[2:10]]
    if all(hasattr(rig, k) for k in _RECT_PARAMS):
        return RectifiedStereoRig(*(copy(getattr(rig, k))
                                    for k in _RECT_PARAMS),
                                  *params, device=device)
    plain = StereoRig(*params, device=device)
    if hasattr(rig, "R_inv"):
        return StructuredLightRig(plain)
    return plain


def graycode_from_jax(scanner, device="cuda"):
    """Port's :class:`GrayCode` or :class:`GrayCodeDouble` scanning what
    ``scanner`` (the JAX package's) scans, on ``device``."""
    from .active import GrayCode, GrayCodeDouble

    rig = rig_from_jax(scanner.rig, device=device)
    kw = dict(black_thr=scanner.black_thr, white_thr=scanner.white_thr,
              device=device)
    if hasattr(scanner, "projRes"):
        return GrayCodeDouble(rig, tuple(scanner.projRes), **kw)
    return GrayCode(rig, **kw)


def ftp_from_jax(ftp, device="cuda"):
    """Port's FTP scanner of the same class (:class:`StereoFTP`,
    :class:`StereoFTPAnaglyph`, :class:`StereoFTP_Mapping` or
    :class:`StereoFTP_PhaseOnly`) computing what ``ftp`` (the JAX
    package's) computes, on ``device``.

    The JAX object keeps the grayscaled fringe, not the projected image,
    so that fringe, its size, the carrier, the stripe's peak and the
    stripe parameters are copied; what follows from the rig is computed
    from the converted rig. A subclass of the user's raises ``TypeError``:
    its grayscale hooks are JAX code."""
    from . import active

    cls = getattr(active, type(ftp).__name__, None)
    if cls is None or not issubclass(cls, active.StereoFTP):
        raise TypeError(f"no port of {type(ftp).__name__}")
    out = cls.__new__(cls)
    out.device = resolve_device(device)
    out._setup(rig_from_jax(ftp.stereoRig, device=device),
               np.array(ftp.fringe, np.float64), tuple(ftp.fringeDims),
               float(ftp.fp), float(ftp.stripeCentralPeak), ftp.stripeColor,
               ftp.stripeSensitivity)
    return out
