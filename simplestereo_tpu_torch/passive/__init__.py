"""
passive
=======

Dense passive stereo matching, PyTorch port of
:mod:`simplestereo_tpu.passive`. So far: the ASW matcher on its CUDA
kernel (:mod:`.asw_cuda`), with the plain twin (:mod:`.asw_ref`) as the
CPU path and oracle, the SGM matcher (:mod:`.sgm`) on its path
aggregation kernel (:mod:`.sgm_cuda`), and the GSW matcher (:mod:`.gsw`,
SD and MI costs) on its support-weight kernel (:mod:`.gsw_cuda`), and the
post-filters: the median (:mod:`.postfilter`), the WLS smoother
(:mod:`.wls`) on its line-solve kernel S2, and the one-call preset
(:mod:`.presets`).
"""

import numpy as np

from .._device import resolve_device
from ._entry import run_numpy
from .lab import bgr_to_lab
from .asw_ref import asw_disparity_ref, occlusion_fill
from .asw_cuda import asw_disparity, asw_disparity_batch
from .sgm import StereoSGM, StereoSGBM_create, filter_speckles
from .gsw import (MI_AUTO_THRESHOLD, StereoGSW, gsw_disparity,
                  gsw_disparity_batch, radiometric_divergence,
                  resolve_cost_method)
from .postfilter import median_disparity
from .wls import fast_global_smoother, wls_filter_disparity
from .presets import quality_disparity


class StereoASW:
    """Adaptive Support-Weight block matcher (Yoon & Kweon 2006).

    Same constructor, validation and results as
    :class:`simplestereo_tpu.passive.StereoASW`, plus ``device``: the
    matcher runs there (``"cuda"``: the hand-written kernel; ``"cpu"``:
    the plain PyTorch twin). A CUDA device without a card raises.

    Parameters
    ----------
    winSize : int
        Side of the square support window (odd). Default 35.
    maxDisparity, minDisparity : int
        Inclusive disparity search range. Defaults 16, 0.
    gammaC, gammaP : float
        Color and proximity weight bandwidths. Defaults 5, 17.5.
    consistent : bool
        Left-right consistency check + occlusion filling.
    step : int
        Window-offset lattice stride (1 = every window pixel).
    subpixel : bool
        Equiangular sub-pixel refinement; ``compute`` returns float32.
    device : str or torch.device
        Where the matcher runs. Default ``"cuda"``.
    """

    def __init__(self, winSize=35, maxDisparity=16, minDisparity=0,
                 gammaC=5, gammaP=17.5, consistent=False, step=1,
                 subpixel=False, device="cuda"):
        if winSize <= 0 or winSize % 2 == 0:
            raise ValueError("winSize must be a positive odd number!")
        if step < 1:
            raise ValueError("step must be >= 1!")
        self.winSize = winSize
        self.maxDisparity = maxDisparity
        self.minDisparity = minDisparity
        self.gammaC = gammaC
        self.gammaP = gammaP
        self.consistent = consistent
        self.step = step
        self.subpixel = subpixel
        self.device = resolve_device(device)

    def _kwargs(self):
        return dict(win_size=self.winSize, max_disp=self.maxDisparity,
                    min_disp=self.minDisparity, gamma_c=float(self.gammaC),
                    gamma_p=float(self.gammaP), consistent=self.consistent,
                    step=self.step, subpixel=self.subpixel)

    def compute(self, img1, img2):
        """Disparity map of the pair, referred to img1.

        (H, W, 3) BGR numpy pair -> (H, W) int16 numpy (float32 when
        ``subpixel``).
        """
        img1 = np.ascontiguousarray(img1)
        img2 = np.ascontiguousarray(img2)
        if img1.ndim != 3 or img1.shape[2] != 3 or img1.shape != img2.shape:
            raise ValueError(
                "Images must be 3-channel BGR with identical shapes!")
        return run_numpy(asw_disparity, img1, img2, self.device,
                         **self._kwargs())

    def computeBatch(self, imgs1, imgs2):
        """Batched :meth:`compute`: (B, H, W, 3) numpy pairs -> (B, H, W)
        int16 numpy (float32 when ``subpixel``), one kernel launch for the
        stack, bit-identical to per-frame :meth:`compute`."""
        imgs1 = np.ascontiguousarray(imgs1)
        imgs2 = np.ascontiguousarray(imgs2)
        if imgs1.ndim != 4 or imgs1.shape[3] != 3 \
                or imgs1.shape != imgs2.shape:
            raise ValueError(
                "Batches must be (B, H, W, 3) BGR with identical shapes!")
        return run_numpy(asw_disparity_batch, imgs1, imgs2, self.device,
                         **self._kwargs())


__all__ = [
    "bgr_to_lab",
    "asw_disparity",
    "asw_disparity_batch",
    "asw_disparity_ref",
    "occlusion_fill",
    "StereoASW",
    "StereoSGM",
    "StereoSGBM_create",
    "filter_speckles",
    "StereoGSW",
    "gsw_disparity",
    "gsw_disparity_batch",
    "radiometric_divergence",
    "resolve_cost_method",
    "MI_AUTO_THRESHOLD",
    "median_disparity",
    "fast_global_smoother",
    "wls_filter_disparity",
    "quality_disparity",
]
