"""
stripe
======

Subpixel colored-stripe localization and illuminated-region detection:
the port of :mod:`simplestereo_tpu.active.stripe`.

:func:`findCentralStripe` and :func:`computeROI` are numpy on the host,
copied; :func:`_stripe_centroids_device` is the per-row centroid
reduction in torch on the frame's device (the FTP preamble keeps the
frame there and brings back only the (H,) centroid vector).
"""

import numpy as np
import torch

_CHANNEL = {"b": 0, "blue": 0, "g": 1, "green": 1, "r": 2, "red": 2}


def _stripe_centroids_device(image, channel, thr):
    """Per-row stripe centroids of an (..., H, W, 3) tensor on its device,
    float32 (NaN where a row has no stripe): the excess of ``channel``
    over the smaller of the other two, zeroed under ``thr``, weighted by
    the column index."""
    img = image.to(torch.float32)
    ch = img[..., channel]
    o1, o2 = (img[..., i] for i in range(3) if i != channel)
    fringe = torch.clamp(ch - torch.minimum(o1, o2), min=0.0)
    fringe = torch.where(fringe < thr, torch.zeros_like(fringe), fringe)
    den = fringe.sum(dim=-1)
    cols = torch.arange(img.shape[-2], dtype=torch.float32,
                        device=img.device)
    num = (fringe * cols).sum(dim=-1)
    return num / den  # NaN rows where den == 0


def findCentralStripe(image, color="r", sensitivity=0.5,
                      interpolation="linear"):
    """Find the colored stripe's subpixel x-center on every row.

    Per-row intensity-weighted centroid after thresholding at
    sensitivity * dtype_max; rows with no stripe are filled by
    linear interpolation/extrapolation over y (the reference uses
    scipy.interp1d with fill_value="extrapolate").

    A tensor is reduced on its device (float32) and only the (H,) vector
    comes back; anything else runs in float64 numpy.

    Returns (H, 2) array of (x, y) with y at pixel centers (0.5, 1.5, ...)
    or None if the stripe is nowhere visible.
    """
    if not 0 <= sensitivity <= 1:
        raise ValueError("Threshold must be in the interval [0,1]!")
    if color not in _CHANNEL:
        raise ValueError("Color value not permitted!")
    c = _CHANNEL[color]
    if isinstance(image, torch.Tensor):
        h = image.shape[0]
        dt = image.dtype
        max_value = (1.0 if dt.is_floating_point
                     else torch.iinfo(dt).max)
        x = _stripe_centroids_device(image, c, max_value * sensitivity)
        return _centroids_to_stripe(x.cpu().numpy().astype(np.float64), h,
                                    interpolation)
    image = np.asarray(image)
    h, w = image.shape[:2]
    dt = np.dtype(str(image.dtype))
    max_value = np.iinfo(dt).max if dt.kind in "iu" else 1.0

    # Excess-color weighting, not the raw channel: the reference
    # thresholds image[:, :, c] directly (active.py:308-320), which also
    # passes the neutral (white) fringe ridges that contain the stripe
    # color. Subtracting the *minimum* of the other channels removes the
    # neutral-light component while keeping overlaid stripes (anaglyph: G
    # sits on top of the R carrier) intact.
    ch = image[:, :, c].astype(np.float64)
    others = np.min(np.delete(image.astype(np.float64), c, axis=2), axis=2)
    fringe = np.clip(ch - others, 0.0, None)
    fringe[fringe < max_value * sensitivity] = 0

    i = np.arange(w)[None, :]
    den = fringe.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        x = (fringe * i).sum(axis=1) / den

    return _centroids_to_stripe(x, h, interpolation)


def _centroids_to_stripe(x, h, interpolation="linear"):
    """Host tail of :func:`findCentralStripe`: fill NaN rows of the
    per-row centroid vector ``x`` by interpolation/extrapolation and
    attach pixel-center y coordinates. None when no row has a stripe."""
    if np.isnan(x).all():
        return None

    y = np.arange(0.5, h, 1.0)
    mask = ~np.isnan(x)
    if interpolation != "linear":
        from scipy.interpolate import interp1d
        f = interp1d(y[mask], x[mask], kind=interpolation,
                     fill_value="extrapolate")
        x = f(y)
    else:
        x = _interp_extrap(y, y[mask], x[mask])
    return np.vstack((x, y)).T


def _interp_extrap(xq, xp, fp):
    """np.interp with linear extrapolation at both ends."""
    out = np.interp(xq, xp, fp)
    if len(xp) >= 2:
        s0 = (fp[1] - fp[0]) / (xp[1] - xp[0])
        s1 = (fp[-1] - fp[-2]) / (xp[-1] - xp[-2])
        lo = xq < xp[0]
        hi = xq > xp[-1]
        out[lo] = fp[0] + s0 * (xq[lo] - xp[0])
        out[hi] = fp[-1] + s1 * (xq[hi] - xp[-1])
    return out


def computeROI(img, blackThreshold=10, extraMargin=0, whiteThreshold=None,
               coverage=0.95):
    """Find the illuminated region of interest as (x, y, width, height).

    Redesigned version of the reference's computeROI (active.py:1611-1695,
    self-described as "to rewrite completely"): threshold, keep the
    largest connected bright component, then shrink the bounding box one
    border at a time until every border row/column is at least
    ``coverage`` inside the component. ``extraMargin`` keeps the
    reference's final safety shrink (active.py:1689-1692): the returned
    rectangle is reduced by that many pixels on every side.
    """
    from scipy.ndimage import label

    img = np.asarray(img)
    if img.ndim == 3:
        g = img.mean(axis=2)
    else:
        g = img.astype(np.float64)
    mask = g > blackThreshold
    if whiteThreshold is not None:
        mask &= g < whiteThreshold
    if not mask.any():
        return (0, 0, img.shape[1], img.shape[0])
    lab, n = label(mask)
    if n > 1:
        counts = np.bincount(lab.ravel())
        counts[0] = 0
        mask = lab == counts.argmax()

    ys, xs = np.nonzero(mask)
    x0, x1 = xs.min(), xs.max() + 1
    y0, y1 = ys.min(), ys.max() + 1
    for _ in range(mask.shape[0] + mask.shape[1]):
        sub = mask[y0:y1, x0:x1]
        fr = [sub[0].mean(), sub[-1].mean(), sub[:, 0].mean(),
              sub[:, -1].mean()]
        worst = int(np.argmin(fr))
        if fr[worst] >= coverage or (y1 - y0) <= 2 or (x1 - x0) <= 2:
            break
        if worst == 0:
            y0 += 1
        elif worst == 1:
            y1 -= 1
        elif worst == 2:
            x0 += 1
        else:
            x1 -= 1
    # Clamp the safety margin so the returned rectangle never collapses
    # to non-positive width/height (a margin >= half the detected box
    # would otherwise produce an empty crop downstream).
    m = max(0, int(extraMargin))
    m = min(m, (int(x1 - x0) - 1) // 2, (int(y1 - y0) - 1) // 2)
    return (int(x0) + m, int(y0) + m, int(x1 - x0) - 2 * m,
            int(y1 - y0) - 2 * m)
