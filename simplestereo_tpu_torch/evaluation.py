"""
evaluation
==========

Middlebury-style disparity-map quality metrics.

Copy of :mod:`simplestereo_tpu.evaluation` (numpy only), kept in the
port because importing the JAX package imports ``jax``. The metric family:
bad-pixel rates, average absolute error, RMS, density.

All metrics are host-side numpy: evaluation is not a hot path, and the
inputs are final (already read back) disparity maps.
"""

import numpy as np

__all__ = ["evaluate_disparity", "tsukuba_scale"]

# The Tsukuba ground-truth PNG stores disparity * 16 (like the golden
# disparityASW.png it ships next to); pass gt_scale=tsukuba_scale for it.
tsukuba_scale = 1.0 / 16.0


def evaluate_disparity(disp, gt, mask=None, *, bad_thresholds=(0.5, 1.0, 2.0, 4.0),
                       invalid=None, disp_scale=1.0, gt_scale=1.0,
                       count_invalid_as_bad=True):
    """Evaluate a disparity map against ground truth.

    Parameters
    ----------
    disp : array_like (H, W)
        Estimated disparity. Fixed-point maps (e.g. :class:`StereoSGM`'s
        OpenCV-convention output, disparity*16) are rescaled by
        ``disp_scale`` (1/16 for SGM output).
    gt : array_like (H, W)
        Ground-truth disparity, rescaled by ``gt_scale``
        (:data:`tsukuba_scale` for the reference's Tsukuba PNG).
    mask : array_like (H, W) of bool, optional
        Evaluation domain (e.g. the non-occluded mask). Default: all
        pixels where ``gt > 0``.
    bad_thresholds : sequence of float
        Thresholds t for the ``bad{t}`` fraction |disp - gt| > t
        (Middlebury bad-0.5/1.0/2.0/4.0 convention).
    invalid : float, optional
        Marker value for invalid pixels in ``disp`` *before* rescaling
        (e.g. ``(minDisparity - 1) * 16`` for SGM, ``-1`` for consistent
        ASW). ``None`` treats every pixel as valid.
    disp_scale, gt_scale : float
        Multipliers applied to ``disp`` / ``gt`` before comparison.
    count_invalid_as_bad : bool
        If True (Middlebury "dense" semantics) invalid pixels inside the
        mask count as bad at every threshold and enter no error average;
        if False they are excluded from all metrics (sparse semantics).

    Returns
    -------
    dict
        ``density`` (valid fraction of the mask), ``bad{t}`` per
        threshold, ``avgerr`` (mean |err| over valid), ``rms``, and
        ``n`` (mask pixel count). Error stats are NaN when nothing is
        valid.
    """
    disp = np.asarray(disp)
    gt = np.asarray(gt)
    if disp.shape != gt.shape:
        raise ValueError(
            f"disp {disp.shape} and gt {gt.shape} shapes differ!")
    if mask is None:
        mask = np.asarray(gt, np.float64) * gt_scale > 0
    else:
        mask = np.asarray(mask).astype(bool)
        if mask.shape != disp.shape:
            raise ValueError(
                f"mask {mask.shape} and disp {disp.shape} shapes differ!")

    valid = np.ones(disp.shape, bool) if invalid is None \
        else disp != invalid
    d = disp.astype(np.float64) * disp_scale
    g = gt.astype(np.float64) * gt_scale
    err = np.abs(d - g)

    n = int(mask.sum())
    vm = valid & mask
    nv = int(vm.sum())
    out = {"n": n, "density": nv / n if n else float("nan")}
    denom = n if count_invalid_as_bad else nv
    for t in bad_thresholds:
        bad = int(((err > t) & vm).sum())
        if count_invalid_as_bad:
            bad += n - nv
        key = f"bad{t:g}"
        out[key] = bad / denom if denom else float("nan")
    out["avgerr"] = float(err[vm].mean()) if nv else float("nan")
    out["rms"] = float(np.sqrt((err[vm] ** 2).mean())) if nv else float("nan")
    return out
