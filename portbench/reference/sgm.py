"""Plain reference of the SGM matcher (Hirschmuller 2008) with the census
cost, as the port states it (``cv2.StereoSGBM``'s surface, example 008),
in PyTorch operations only; it imports nothing of the program.

For (N, H, W, 3) BGR pairs and candidates d in [minDisparity,
minDisparity + numDisparities) (target column x - d):

- gray = 0.299 R + 0.587 G + 0.114 B (ITU-R 601, in that order);
- census over a censusWindow square: bit k of a pixel is 1 where the k-th
  neighbour (row-major, the centre skipped; the image's edge repeated
  beyond it) is brighter than the pixel;
- C(p, d) = the number of bits in which the left pixel's code and the
  code of the right pixel at column x - d differ (the edge column
  repeated where x - d leaves the image), summed over a blockSize square
  (the edge repeated);
- for each of the 8 directions r (4 with ``paths`` 4):
  L_r(p, d) = C(p, d) + min(L_r(p-r, d), L_r(p-r, d-1) + P1,
  L_r(p-r, d+1) + P1, min_d' L_r(p-r, d') + P2) - min_d' L_r(p-r, d'),
  with d -+ 1 held inside the range and L_r = 0 before a scan line's
  first pixel; S = sum_r L_r;
- candidates whose x - d leaves the image are out; the map is the first
  d of least S, rejected when another candidate more than one away is
  within uniquenessRatio percent; with subpixel the quadratic fit through
  the neighbours' S (a missing neighbour takes the least S), within half
  a pixel, at interior d; with disp12MaxDiff >= 0 the left-right check
  against the right map argmin_d S(x + d, d); x 16 and rounded to int16,
  (minDisparity - 1) x 16 where rejected.

Census costs, box sums and the path costs are whole numbers below 2**24
at these sizes, so in float32 every one of them is exact. ``dtype`` sets
the precision of the float steps (float32 as the port states; the
control runs one step below, in bfloat16).
"""

import torch


def _edge_index(n, p, device):
    return torch.arange(-p, n + p, device=device).clamp(0, n - 1)


def census_cost(g1, g2, win, dmin, D):
    """(N, H, W, D) Hamming distances between the census codes of the
    (N, H, W) gray images; float in ``g1``'s dtype."""
    N, H, W = g1.shape
    dev = g1.device
    p = win // 2
    rows, cols = _edge_index(H, p, dev), _edge_index(W, p, dev)
    pad1 = g1[:, rows][:, :, cols]
    pad2 = g2[:, rows][:, :, cols]
    src = (torch.arange(W, device=dev)[:, None]
           - torch.arange(dmin, dmin + D, device=dev)[None, :]).clamp(0, W - 1)
    cost = torch.zeros((N, H, W, D), dtype=g1.dtype, device=dev)
    for di in range(-p, p + 1):
        for dj in range(-p, p + 1):
            if di == 0 and dj == 0:
                continue
            b1 = pad1[:, p + di:p + di + H, p + dj:p + dj + W] > g1
            b2 = pad2[:, p + di:p + di + H, p + dj:p + dj + W] > g2
            cost = cost + (b1[..., None] != b2[:, :, src]).to(g1.dtype)
    return cost


def box_sum(vol, k):
    """Sum of (N, H, W, D) over a k x k window, the edge repeated: rows
    first, then columns."""
    if k <= 1:
        return vol
    p = k // 2
    N, H, W, D = vol.shape
    v = vol[:, _edge_index(H, p, vol.device)][:, :, _edge_index(
        W, p, vol.device)]
    s = v[:, 0:H]
    for di in range(1, k):
        s = s + v[:, di:di + H]
    out = s[:, :, 0:W]
    for dj in range(1, k):
        out = out + s[:, :, dj:dj + W]
    return out


def _step(prev, c, P1, P2):
    """One step of the recurrence on (..., D) path costs."""
    m = prev.amin(-1, keepdim=True)
    up = torch.cat([prev[..., 1:], prev[..., -1:]], -1)   # d + 1, held
    dn = torch.cat([prev[..., :1], prev[..., :-1]], -1)   # d - 1, held
    best = torch.minimum(torch.minimum(prev, torch.minimum(up, dn) + P1),
                         m + P2)
    return c + best - m


def aggregate(C, P1, P2, paths):
    """S = sum of the path costs over 4 or 8 directions of (N, H, W, D)."""
    N, H, W, D = C.shape
    S = torch.zeros_like(C)
    for xs in (range(W), range(W - 1, -1, -1)):        # along the rows
        prev = None
        for x in xs:
            cur = C[:, :, x] if prev is None else _step(prev, C[:, :, x],
                                                        P1, P2)
            S[:, :, x] += cur
            prev = cur
    rolls = (0, 1, -1) if paths >= 8 else (0,)
    zero = torch.zeros((N, 1, D), dtype=C.dtype, device=C.device)
    for dx in rolls:                                    # down the columns
        for ys in (range(H), range(H - 1, -1, -1)):
            prev = None
            for y in ys:
                if prev is None:
                    cur = C[:, y]
                else:
                    if dx > 0:     # predecessor at column x - 1
                        prev = torch.cat([zero, prev[:, :-1]], 1)
                    elif dx < 0:   # predecessor at column x + 1
                        prev = torch.cat([prev[:, 1:], zero], 1)
                    cur = _step(prev, C[:, y], P1, P2)
                S[:, y] += cur
                prev = cur
    return S


def post(S, dmin, uniqueness, max_diff, subpixel):
    """(N, H, W) int16 disparity x 16 of the path sum S."""
    N, H, W, D = S.shape
    dev = S.device
    xs = torch.arange(W, device=dev)[:, None]
    ds = torch.arange(dmin, dmin + D, device=dev)[None, :]
    S = torch.where((xs - ds >= 0) & (xs - ds <= W - 1), S, torch.inf)
    best = torch.argmin(S, -1)
    s_best = S.amin(-1)
    valid = torch.isfinite(s_best)
    if uniqueness > 0:
        far = (torch.arange(D, device=dev) - best[..., None]).abs() > 1
        s2 = torch.where(far, S, torch.inf).amin(-1)
        valid &= ~(s2 * 100.0 < s_best * (100.0 + uniqueness))
    disp16 = (best + dmin).to(S.dtype) * 16.0
    if subpixel:
        bm1 = S.gather(-1, (best - 1).clamp(min=0)[..., None])[..., 0]
        bp1 = S.gather(-1, (best + 1).clamp(max=D - 1)[..., None])[..., 0]
        bm1 = torch.where(torch.isfinite(bm1), bm1, s_best)
        bp1 = torch.where(torch.isfinite(bp1), bp1, s_best)
        denom = bm1 + bp1 - 2.0 * s_best
        delta = torch.where(denom > 1e-6, (bm1 - bp1) / (2.0 * denom), 0.0)
        delta = delta.clamp(-0.5, 0.5)
        interior = (best > 0) & (best < D - 1)
        disp16 = disp16 + torch.where(interior, delta, 0.0) * 16.0
    if max_diff >= 0:
        cols = (xs + ds).clamp(0, W - 1)
        S_r = torch.where((xs + ds >= 0) & (xs + ds <= W - 1),
                          S.gather(2, cols.expand(S.shape)), torch.inf)
        disp_r = torch.argmin(S_r, -1) + dmin
        match = (torch.arange(W, device=dev) - (best + dmin)).clamp(0, W - 1)
        valid &= (disp_r.gather(-1, match) - (best + dmin)).abs() <= max_diff
    out = torch.where(valid, disp16, float((dmin - 1) * 16))
    return torch.round(out).to(torch.int16)


def disparity(config, lefts, rights, device, dtype=torch.float32, block=4):
    """(N, H, W) int16 maps (disparity x 16) of the (N, H, W, 3) uint8
    pairs, computed on ``device`` in blocks of ``block`` frames."""
    p = config["params"]
    if p.get("costMethod") != "census":
        raise ValueError("the SGM reference has the census cost only")
    dmin, D = p["minDisparity"], p["numDisparities"]
    out = []
    for b in range(0, len(lefts), block):
        grays = []
        for imgs in (lefts[b:b + block], rights[b:b + block]):
            t = torch.as_tensor(imgs, device=device)
            bl, gr, rd = (t[..., i].to(dtype) for i in range(3))
            grays.append(0.299 * rd + 0.587 * gr + 0.114 * bl)
        C = box_sum(census_cost(*grays, p["censusWindow"], dmin, D),
                    p["blockSize"])
        S = aggregate(C, float(p["P1"]), float(p["P2"]), p.get("paths", 8))
        del C
        out.append(post(S, dmin, float(p.get("uniquenessRatio", 10)),
                        p.get("disp12MaxDiff", -1),
                        p.get("subpixel", True)).cpu())
        del S
    return torch.cat(out).numpy()
