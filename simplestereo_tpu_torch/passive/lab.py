"""
lab
===

BGR -> CIELab conversion with the reference's exact constants.

Port of :mod:`simplestereo_tpu.passive.lab` (sRGB -> XYZ -> Lab, D65,
2-degree observer, the reference's own constants rather than OpenCV's).
The cube root on the ``t > 0.008856`` branch is ``torch.pow(t, 1/3)``
(PyTorch has no ``cbrt``); it differs from ``jnp.cbrt`` by a few float32
ulps, which the tests bound.
"""

import torch


def bgr_to_lab(img):
    """Convert a BGR image to CIELab (reference-parity constants).

    Parameters
    ----------
    img : torch.Tensor
        (..., 3) BGR, uint8 or float in [0, 255].

    Returns
    -------
    torch.Tensor
        (..., 3) float32 L, a, b (L in [0, 100]), on ``img``'s device.
    """
    x = img.to(torch.float32) / 255.0
    b, g, r = x[..., 0], x[..., 1], x[..., 2]

    def srgb_inv_gamma(c):
        return torch.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4,
                           c / 12.92)

    r = srgb_inv_gamma(r) * 100.0
    g = srgb_inv_gamma(g) * 100.0
    b = srgb_inv_gamma(b) * 100.0

    # D65 / 2-degree observer matrix (the reference's colorconversion.hpp).
    X = r * 0.4124 + g * 0.3576 + b * 0.1805
    Y = r * 0.2126 + g * 0.7152 + b * 0.0722
    Z = b * 0.9505 + r * 0.0193 + g * 0.1192

    X = X / 95.047
    Y = Y / 100.0
    Z = Z / 108.883

    def f(t):
        # t > 0.008856 on the pow branch, so the base is positive.
        return torch.where(t > 0.008856, torch.pow(t, 1.0 / 3.0),
                           7.787 * t + 16.0 / 116.0)

    fx, fy, fz = f(X), f(Y), f(Z)
    L = 116.0 * fy - 16.0
    a = 500.0 * (fx - fy)
    bb = 200.0 * (fy - fz)
    return torch.stack([L, a, bb], dim=-1)
