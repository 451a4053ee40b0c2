"""Plain reference of the ASW matcher (Yoon & Kweon 2006) as the port
states it, in PyTorch operations only; it imports nothing of the program.

For each pixel p of the left image and each candidate d in
[minDisparity, maxDisparity] (target column x - d):

- Lab of both images by the sRGB -> XYZ -> Lab formulas (D65, 2 degree
  observer, the reference library's constants; the cube root as
  ``pow(t, 1/3)``);
- for every window offset o on the lattice of ``step``:
  w = exp(-2 |o| / gammaP) * exp(-(||Lab1(p+o) - Lab1(p)||
  + ||Lab2(p-d+o) - Lab2(p-d)||) / gammaC), and
  t = min(40, sum over B, G, R of |I1(p+o) - I2(p+o-d)|);
  a window pixel whose row, reference column or target column leaves the
  image is left out of both sums;
- cost(p, d) = sum(w t) / sum(w), infinite where x - d leaves the image;
- the left map: the first (smallest) d of least cost, the pixel's own
  column where no candidate exists;
- with ``consistent``: the right map from the right image's costs, which
  are cost_R(x, d) = cost(x + d, d) (the weight and the truncated
  difference are symmetric in the two images: the same terms in the same
  order), -x where no candidate exists; the left-right check marks every
  left pixel that some right pixel's match points at without agreeing,
  and each marked run is filled with the smaller of its nearest valid
  neighbours (one side at a border; -1 marks, or minDisparity - 1 when
  -1 is a legal disparity).

``dtype`` sets the precision of every float step (the configuration
states float32; the control runs it one step below, in bfloat16).
"""

import numpy as np
import torch

TAD_CAP = 40.0


def bgr_to_lab(img):
    """(..., 3) BGR in [0, 255] -> (..., 3) L, a, b in ``img``'s dtype."""
    x = img / 255.0
    b, g, r = x[..., 0], x[..., 1], x[..., 2]

    def linear(c):
        return torch.where(c > 0.04045, ((c + 0.055) / 1.055) ** 2.4,
                           c / 12.92)

    r, g, b = linear(r) * 100.0, linear(g) * 100.0, linear(b) * 100.0
    X = (r * 0.4124 + g * 0.3576 + b * 0.1805) / 95.047
    Y = (r * 0.2126 + g * 0.7152 + b * 0.0722) / 100.0
    Z = (b * 0.9505 + r * 0.0193 + g * 0.1192) / 108.883

    def f(t):
        return torch.where(t > 0.008856, torch.pow(t, 1.0 / 3.0),
                           7.787 * t + 16.0 / 116.0)

    fx, fy, fz = f(X), f(Y), f(Z)
    return torch.stack([116.0 * fy - 16.0, 500.0 * (fx - fy),
                        200.0 * (fy - fz)], dim=-1)


def cost_volume(bgr1, bgr2, win, gamma_c, gamma_p, dmin, dmax, step=1):
    """(N, H, W, D) costs of left images ``bgr1`` against ``bgr2``, both
    (N, H, W, 3) in the working dtype."""
    N, H, W, _ = bgr1.shape
    dev, dt = bgr1.device, bgr1.dtype
    pad = win // 2
    ds = torch.arange(dmin, dmax + 1, device=dev)
    xs = torch.arange(W, device=dev)
    ys = torch.arange(H, device=dev)
    tx = xs[:, None] - ds[None, :]                       # (W, D)
    cand_ok = (tx >= 0) & (tx <= W - 1)
    txc = tx.clamp(0, W - 1)
    lab1, lab2 = bgr_to_lab(bgr1), bgr_to_lab(bgr2)
    tad = (bgr1[:, :, :, None, :] - bgr2[:, :, txc, :]).abs().sum(-1)
    tad = tad.clamp(max=TAD_CAP)                         # (N, H, W, D)

    def padded(a):  # zero rows and columns around (N, H, W, ...)
        shape = list(a.shape)
        shape[1] += 2 * pad
        shape[2] += 2 * pad
        out = a.new_zeros(shape)
        out[:, pad:pad + H, pad:pad + W] = a
        return out

    lab1p, lab2p, tadp = padded(lab1), padded(lab2), padded(tad)
    num = torch.zeros((N, H, W, len(ds)), dtype=dt, device=dev)
    den = torch.zeros_like(num)
    for di in range(-pad, pad + 1):
        if di % step:
            continue
        row_ok = (ys + di >= 0) & (ys + di <= H - 1)
        rows = slice(pad + di, pad + di + H)
        for dj in range(-pad, pad + 1):
            if dj % step:
                continue
            cols = slice(pad + dj, pad + dj + W)
            prox = torch.exp(-2.0 * torch.sqrt(torch.tensor(
                float(di * di + dj * dj), dtype=dt, device=dev)) / gamma_p)
            dl1 = ((lab1p[:, rows, cols] - lab1) ** 2).sum(-1).sqrt()
            dl2 = ((lab2p[:, rows, cols] - lab2) ** 2).sum(-1).sqrt()
            w = prox * torch.exp(-(dl1[..., None] + dl2[:, :, txc])
                                 / gamma_c)
            ok = (row_ok[:, None, None] & ((xs + dj >= 0)
                                          & (xs + dj <= W - 1))[None, :, None]
                  & (tx + dj >= 0) & (tx + dj <= W - 1))
            w = torch.where(ok, w, 0.0)
            num = num + w * tadp[:, rows, cols]
            den = den + w
    return torch.where(cand_ok, num / den, torch.inf)


def _fill(disp, marker):
    """Each run of ``marker`` in a row of (N, H, W) int64 ``disp`` filled
    with the smaller of the nearest valid values left and right (the one
    there is at a border; a row with none stays marked)."""
    W = disp.shape[-1]
    valid = disp != marker
    idx = np.broadcast_to(np.arange(W), disp.shape)
    left = np.maximum.accumulate(np.where(valid, idx, -1), axis=-1)
    right = np.minimum.accumulate(np.where(valid, idx, W)[..., ::-1],
                                  axis=-1)[..., ::-1]
    lv = np.take_along_axis(disp, left.clip(0), -1)
    rv = np.take_along_axis(disp, right.clip(max=W - 1), -1)
    has_l, has_r = left >= 0, right <= W - 1
    fill = np.where(has_l & has_r, np.minimum(lv, rv),
                    np.where(has_l, lv, np.where(has_r, rv, marker)))
    return np.where(valid, disp, fill)


def lr_check(dl, dr, dmin):
    """Left-right check and occlusion fill of (N, H, W) int64 maps."""
    W = dl.shape[-1]
    marker = -1 if dmin >= 0 else dmin - 1
    target = np.clip(np.arange(W) + dr, 0, W - 1)
    agree = np.take_along_axis(dl, target, -1) == dr
    rows = np.arange(dl.size // W).reshape(dl.shape[:-1] + (1,)) * W
    disagree = np.zeros(dl.size, bool)
    disagree[(rows + target)[~agree]] = True
    disagree = disagree.reshape(dl.shape)
    return _fill(np.where(disagree, marker, dl), marker)


def disparity(config, lefts, rights, device, dtype=torch.float32,
              block=8):
    """(N, H, W) int16 maps of the (N, H, W, 3) uint8 pairs, computed on
    ``device`` in blocks of ``block`` frames."""
    p = config["params"]
    if p.get("subpixel", False):
        raise ValueError("the ASW reference has no subpixel step")
    win, dmin, dmax = p["winSize"], p["minDisparity"], p["maxDisparity"]
    W = lefts.shape[2]
    xs = np.arange(W)
    out = []
    for b in range(0, len(lefts), block):
        t1 = torch.as_tensor(lefts[b:b + block], device=device).to(dtype)
        t2 = torch.as_tensor(rights[b:b + block], device=device).to(dtype)
        cost = cost_volume(t1, t2, win, float(p["gammaC"]),
                           float(p["gammaP"]), dmin, dmax, p.get("step", 1))
        dl = (torch.argmin(cost, -1) + dmin).cpu().numpy()
        dl = np.where(xs < dmin, xs, dl)
        if not p.get("consistent", False):
            out.append(dl)
            continue
        src = torch.arange(W, device=device)[:, None] + torch.arange(
            dmin, dmax + 1, device=device)[None, :]           # (W, D)
        ok = (src >= 0) & (src <= W - 1)
        right = torch.where(ok, torch.gather(
            cost, 2, src.clamp(0, W - 1)[None, None].expand(cost.shape)),
            torch.inf)
        dr = (torch.argmin(right, -1) + dmin).cpu().numpy()
        dr = np.where(W - 1 - xs < dmin, -xs, dr)
        out.append(lr_check(dl, dr, dmin))
        del cost, right
    return np.concatenate(out).astype(np.int16)
