"""
convert
=======

Build the port's objects from their JAX-package counterparts.

The matchers hold no learned weights: their whole state is their
constructor parameters (for SGM with P1 and P2 already resolved from
their defaults), so converting one is reading them. The JAX matchers'
engine choice (``aggregator``, ``engine``) has no counterpart: the
device decides. Attributes are read
with ``getattr``, so this module imports neither ``jax`` nor
``simplestereo_tpu``.
"""

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
