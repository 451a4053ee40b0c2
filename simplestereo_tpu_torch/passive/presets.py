"""
presets
=======

Best-quality composite operating points in one call, the port of
:mod:`simplestereo_tpu.passive.presets` (its module docstring keeps the
Tsukuba table behind the defaults). Both legs run on one device: the ASW
leg on the K1 kernel (:func:`.asw_cuda.asw_disparity`), the SGM leg on K2
(:class:`.sgm.StereoSGM`'s census configuration) and the WLS fill on S2
(:func:`.wls.wls_filter_disparity`). The maps stay on the device between
the stages.
"""

import numpy as np
import torch

from .._device import resolve_device
from .asw_cuda import asw_disparity
from .sgm import StereoSGM
from .wls import wls_filter_disparity

__all__ = ["quality_disparity"]


def _gray_guide(img):
    """Channel-mean guide for the WLS filter (float32, 0..255), averaged
    in float64 as numpy's ``mean`` does, then rounded once."""
    g = img.to(torch.float64)
    return (g.mean(-1) if g.dim() == 3 else g).to(torch.float32)


def quality_disparity(img1, img2, min_disp=0, max_disp=16, *,
                      matcher="asw", win_size=35, gamma_c=15.0,
                      gamma_p=17.5, subpixel=False, block_size=3,
                      p1=120, p2=480, wls_lambda=None,
                      wls_sigma_color=None, device="cuda"):
    """Best-quality disparity in one call: the tuned matcher plus the
    optional sub-pixel and WLS levers, as
    :func:`simplestereo_tpu.passive.quality_disparity` (same parameters,
    defaults and results).

    Parameters
    ----------
    img1, img2 : (H, W, 3) uint8 BGR pair (rectified), tensors (run on
        their device) or arrays (run on ``device``, default ``"cuda"``).
    min_disp, max_disp : int
        Inclusive disparity search range (``matcher="sgm"`` widens it to
        the next multiple of 16 candidates).
    matcher : "asw" | "sgm"
        "asw": consistent ASW at the tuned bandwidths. "sgm": census SGM
        with LR check + uniqueness, then the WLS fill of the invalidated
        pixels.
    subpixel : bool
        Equiangular sub-pixel refinement (ASW leg).
    wls_lambda, wls_sigma_color : float or None
        The WLS pass (off on the ASW leg unless ``wls_lambda`` is given;
        lambda 2 and sigma 8 on the SGM leg's fill; sigma 2 on the ASW
        leg).

    Returns
    -------
    (H, W) float32 disparity in pixel units, dense: a tensor for tensor
    images, else numpy.
    """
    is_tensor = isinstance(img1, torch.Tensor)
    if is_tensor:
        t1 = img1
        t2 = img2.to(t1.device) if isinstance(img2, torch.Tensor) \
            else torch.tensor(np.asarray(img2), device=t1.device)
    else:
        dev = resolve_device(device)
        t1 = torch.tensor(np.asarray(img1), device=dev)
        t2 = torch.tensor(np.asarray(img2), device=dev)
    if t1.dim() != 3 or t1.shape[2] != 3 or t1.shape != t2.shape:
        raise ValueError(
            "Images must be 3-channel BGR with identical shapes!")

    if matcher == "asw":
        disp = asw_disparity(
            t1, t2, win_size=win_size, min_disp=min_disp, max_disp=max_disp,
            gamma_c=float(gamma_c), gamma_p=float(gamma_p), consistent=True,
            subpixel=bool(subpixel)).to(torch.float32)
        if wls_lambda is not None:
            # consistent ASW is already dense (occlusion fill); WLS smooths
            disp = wls_filter_disparity(
                disp, _gray_guide(t1), lambda_=float(wls_lambda),
                sigma_color=(2.0 if wls_sigma_color is None
                             else float(wls_sigma_color)))
    elif matcher == "sgm":
        num = -(-(max_disp - min_disp + 1) // 16) * 16
        m = StereoSGM(minDisparity=min_disp, numDisparities=num,
                      blockSize=block_size, P1=p1, P2=p2,
                      uniquenessRatio=10, disp12MaxDiff=1,
                      costMethod="census", censusWindow=7, device=t1.device)
        d16 = m.compute(t1, t2)
        lam = 2.0 if wls_lambda is None else float(wls_lambda)
        disp = wls_filter_disparity(
            d16, _gray_guide(t1), lambda_=lam,
            sigma_color=(8.0 if wls_sigma_color is None
                         else float(wls_sigma_color)),
            invalid=(min_disp - 1) * 16, disp_scale=1 / 16.0)
    else:
        raise ValueError("matcher must be 'asw' or 'sgm'!")
    return disp if is_tensor else disp.cpu().numpy()
