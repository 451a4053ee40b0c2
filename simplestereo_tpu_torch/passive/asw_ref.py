"""
asw_ref
=======

Plain PyTorch twin of the Adaptive Support-Weight matcher: the oracle the
CUDA kernel (:mod:`.asw_cuda`) is checked against, and the CPU path.

Port of :mod:`simplestereo_tpu.passive.asw_ref` (same semantics, same
arithmetic order), with one deliberate difference: a disparity candidate,
or a target window pixel, whose column leaves ``[0, W-1]`` on EITHER side
is invalid. The JAX oracle checks only the side that ``min_disp >= 0`` can
reach (``asw_ref.py`` ``cand_ok``/``tgt_col_ok``), so for negative
``min_disp`` it scores columns outside the image; for ``min_disp >= 0``
the two are the same function.

- support weight  w1*w2 = exp(-2*sqrt(di^2+dj^2)/gammaP)
  * exp(-(||dLab1|| + ||dLab2||)/gammaC), window pixels outside the image
  excluded from numerator and denominator;
- matching cost   sum(w * min(40, SAD_BGR)) / sum(w);
- ties broken toward the smallest disparity (first minimum);
- pixels with no valid candidate output their own column index;
- consistent mode: a second volume with the right image as reference, a
  left-right check, and :func:`occlusion_fill`.
"""

import torch

from .lab import bgr_to_lab

TAD_CAP = 40.0


def _shift_x(a, s, fill=0.0):
    """a shifted along axis 1 so that out[:, x] = a[:, x+s] (constant fill)."""
    if s == 0:
        return a
    W = a.shape[1]
    shape = list(a.shape)
    shape[1] = min(abs(s), W)
    f = a.new_full(shape, fill)
    if s > 0:
        return torch.cat([a[:, s:], f], dim=1)
    return torch.cat([f, a[:, :max(W + s, 0)]], dim=1)


def _shift_y(a, s, fill=0.0):
    """a shifted along axis 0 so that out[y] = a[y+s] (constant fill)."""
    if s == 0:
        return a
    H = a.shape[0]
    shape = list(a.shape)
    shape[0] = min(abs(s), H)
    f = a.new_full(shape, fill)
    if s > 0:
        return torch.cat([a[s:], f], dim=0)
    return torch.cat([f, a[:max(H + s, 0)]], dim=0)


def _cost_volume(img_ref, img_tgt, lab_ref, lab_tgt, win_size, gamma_c,
                 gamma_p, min_disp, max_disp, direction, step=1):
    """ASW cost volume (H, W, D) float32 for one matching direction.

    direction=+1: reference is the left image, target column = x - d.
    direction=-1: reference is the right image, target column = x + d.
    step: window-offset lattice stride, anchored at the centre.

    Returns ``(cost, cand_ok)``: ``cost`` is ``inf`` where the target
    column leaves the image; ``cand_ok`` (1, W, D) bool marks the rest.
    """
    H, W = img_ref.shape[:2]
    dev = img_ref.device
    pad = win_size // 2
    D = max_disp - min_disp + 1
    xs = torch.arange(W, device=dev)
    rows = torch.arange(H, device=dev)
    disps = torch.arange(min_disp, max_disp + 1, device=dev)

    num = torch.zeros((H, W, D), dtype=torch.float32, device=dev)
    den = torch.zeros((H, W, D), dtype=torch.float32, device=dev)

    tgt_x = xs[None, :, None] - direction * disps[None, None, :]
    cand_ok = (tgt_x >= 0) & (tgt_x <= W - 1)

    # tad[..., d](y, x) = min(40, SAD(ref(y, x), tgt(y, x -/+ d))).
    tad = torch.stack(
        [torch.clamp(
            (img_ref - _shift_x(img_tgt, -direction * d)).abs().sum(-1),
            max=TAD_CAP)
         for d in range(min_disp, max_disp + 1)], -1)

    for di in range(-pad, pad + 1):
        if di % step:
            continue
        row_ok = (rows + di >= 0) & (rows + di <= H - 1)
        for dj in range(-pad, pad + 1):
            if dj % step:
                continue
            prox = torch.exp(-2.0 * torch.sqrt(torch.tensor(
                float(di * di + dj * dj), dtype=torch.float32,
                device=dev)) / gamma_p)
            col_ok = (xs + dj >= 0) & (xs + dj <= W - 1)

            # ||Lab(y+di, x+dj) - Lab(y, x)|| on both images.
            dl_ref = torch.sqrt(((_shift_y(_shift_x(lab_ref, dj), di)
                                  - lab_ref) ** 2).sum(-1))
            dl_tgt = torch.sqrt(((_shift_y(_shift_x(lab_tgt, dj), di)
                                  - lab_tgt) ** 2).sum(-1))
            # dl_tgt evaluated at the target centre x -/+ d.
            dl_tgt_d = torch.stack(
                [_shift_x(dl_tgt, -direction * d)
                 for d in range(min_disp, max_disp + 1)], -1)

            w = prox * torch.exp(-(dl_ref[..., None] + dl_tgt_d) / gamma_c)

            # Window-pixel validity: row, reference column, and target
            # column x + dj -/+ d, both bounds.
            tgt_win_x = tgt_x + dj
            valid = (row_ok[:, None, None] & col_ok[None, :, None]
                     & (tgt_win_x >= 0) & (tgt_win_x <= W - 1))
            w = torch.where(valid, w, 0.0)

            t = _shift_y(_shift_x(tad, dj), di)
            num = num + w * t
            den = den + w

    cost = num / den
    cost = torch.where(cand_ok, cost, torch.inf)
    return cost, cand_ok


def _argmin_disp(cost, cand_ok, min_disp, fallback):
    """Disparity with smallest-d tie-break; ``fallback`` where no candidate."""
    best = torch.argmin(cost, dim=-1) + min_disp
    return torch.where(cand_ok.any(-1), best, fallback)


def occlusion_fill(disp, invalid=-1):
    """Fill invalid runs along the last axis with min(nearest valid
    left/right value).

    Border runs take the single available side; rows with no valid pixel
    stay ``invalid``. ``invalid`` is settable because -1 is a legal
    disparity when minDisparity < 0 (consistent mode then marks with
    minDisparity - 1). Works on (..., W): every leading index is a row.
    """
    W = disp.shape[-1]
    valid = disp != invalid
    xs = torch.arange(W, device=disp.device).expand(disp.shape)

    idx_left = torch.where(valid, xs, -1)
    last_valid = torch.cummax(idx_left, dim=-1).values
    left_val = torch.gather(disp, -1, last_valid.clamp(min=0))
    has_left = last_valid >= 0

    idx_right = torch.where(valid, xs, W)
    next_valid = torch.flip(
        torch.cummin(torch.flip(idx_right, [-1]), dim=-1).values, [-1])
    right_val = torch.gather(disp, -1, next_valid.clamp(max=W - 1))
    has_right = next_valid <= W - 1

    both = torch.minimum(left_val, right_val)
    fill = torch.where(has_left & has_right, both,
                       torch.where(has_left, left_val,
                                   torch.where(has_right, right_val,
                                               invalid)))
    return torch.where(valid, disp, fill)


def lr_check(dispL, dispR, min_disp):
    """Left-right consistency check with occlusion fill, along the last
    axis of (..., W) maps: every left pixel that some right pixel's match
    points at without agreeing is marked, then filled. Returns int64.

    The marker is -1, or ``min_disp - 1`` when -1 is a legal disparity.
    """
    W = dispL.shape[-1]
    dispL = dispL.long()
    dispR = dispR.long()
    marker = -1 if min_disp >= 0 else min_disp - 1
    xs = torch.arange(W, device=dispL.device)
    L = torch.clamp(xs + dispR, 0, W - 1)
    agree = torch.gather(dispL, -1, L) == dispR
    disagree = torch.zeros(dispL.shape, dtype=torch.int32,
                           device=dispL.device)
    disagree.scatter_reduce_(-1, L, (~agree).to(torch.int32), "amax")
    dispI = torch.where(disagree.bool(), marker, dispL)
    return occlusion_fill(dispI, invalid=marker)


def asw_disparity_ref(img1, img2, win_size=35, max_disp=16, min_disp=0,
                      gamma_c=5.0, gamma_p=17.5, consistent=False, step=1):
    """Reference-semantics ASW disparity (plain PyTorch oracle).

    img1, img2 : (H, W, 3) BGR tensors (uint8 or float in [0, 255]).

    Returns
    -------
    torch.Tensor
        (H, W) int16 disparity, on the inputs' device.
    """
    H, W = img1.shape[:2]
    xs = torch.arange(W, device=img1.device).expand(H, W)

    f1 = img1.to(torch.float32)
    f2 = img2.to(torch.float32)
    lab1 = bgr_to_lab(img1)
    lab2 = bgr_to_lab(img2)

    costL, okL = _cost_volume(f1, f2, lab1, lab2, win_size, gamma_c, gamma_p,
                              min_disp, max_disp, +1, step)
    dispL = _argmin_disp(costL, okL, min_disp, xs)
    if not consistent:
        return dispL.to(torch.int16)

    costR, okR = _cost_volume(f2, f1, lab2, lab1, win_size, gamma_c, gamma_p,
                              min_disp, max_disp, -1, step)
    # No candidate on the right pass: matched left column 0, disparity -x.
    dispR = _argmin_disp(costR, okR, min_disp, -xs)
    return lr_check(dispL, dispR, min_disp).to(torch.int16)
