"""
postfilter
==========

Disparity post-filtering on tensors, the port of
:mod:`simplestereo_tpu.passive.postfilter`: the median filter that
``cv2.medianBlur`` is to ``cv2.StereoSGBM`` pipelines. The host-side
connected-component speckle filter is
:func:`simplestereo_tpu_torch.passive.sgm.filter_speckles`.

Plain torch: the ``size**2`` shifted views of an edge-replicated map and
their median. The window count is odd, so the median is one of the window's
values and is exact in any dtype; NaN propagates, as in ``jnp.median``.
"""

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["median_disparity"]


def _median2d(img, size):
    """Median over the size x size window of every pixel of a (..., H, W)
    stack, borders replicated (``mode='edge'``); the input's dtype."""
    p = size // 2
    H, W = img.shape[-2:]
    ys = torch.arange(-p, H + p, device=img.device).clamp(0, H - 1)
    xs = torch.arange(-p, W + p, device=img.device).clamp(0, W - 1)
    g = img[..., ys, :][..., xs]
    stack = torch.stack([g[..., i:i + H, j:j + W]
                         for i in range(size) for j in range(size)])
    return torch.median(stack, dim=0).values.to(img.dtype)


def median_disparity(disparity, size=3, *, device="cuda"):
    """Median-filter a disparity map (``cv2.medianBlur`` counterpart).

    Parameters
    ----------
    disparity : tensor or array_like (H, W) or (B, H, W)
        Disparity map(s), any dtype; the output keeps it. Isolated invalid
        markers are what the median removes (edge-replicated borders).
        A tensor runs on its device; anything else on ``device``.
    size : int
        Odd window size.

    Returns
    -------
    A tensor of the input's shape and dtype for a tensor, else numpy.
    """
    if size < 1 or size % 2 == 0:
        raise ValueError("size must be a positive odd number!")
    is_tensor = isinstance(disparity, torch.Tensor)
    d = (disparity if is_tensor else
         torch.tensor(np.asarray(disparity), device=resolve_device(device)))
    if d.dim() not in (2, 3):
        raise ValueError("disparity must be (H, W) or (B, H, W)!")
    out = _median2d(d, size)
    return out if is_tensor else out.cpu().numpy()
