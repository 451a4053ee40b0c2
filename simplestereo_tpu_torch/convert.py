"""
convert
=======

Build the port's objects from their JAX-package counterparts.

The ASW matcher holds no learned weights: its whole state is its eight
constructor parameters, so converting one is reading them. Attributes
are read with ``getattr``, so this module imports neither ``jax`` nor
``simplestereo_tpu``.
"""

from .passive import StereoASW

_ASW_PARAMS = ("winSize", "maxDisparity", "minDisparity", "gammaC", "gammaP",
               "consistent", "step", "subpixel")


def asw_from_jax(matcher, device="cuda"):
    """Port's :class:`StereoASW` computing what ``matcher`` (a
    ``simplestereo_tpu.passive.StereoASW``) computes, on ``device``."""
    return StereoASW(**{k: getattr(matcher, k) for k in _ASW_PARAMS},
                     device=device)
