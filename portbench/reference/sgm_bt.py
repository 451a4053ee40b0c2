"""Plain reference of the SGM matcher (Hirschmuller 2008) with the
Birchfield-Tomasi cost (Birchfield and Tomasi 1998), the left-right check
and the speckle filter, as the port states them (``cv2.StereoSGBM``'s
surface, example 011), in PyTorch operations only; it imports nothing of
the program. The path recurrence, the winner's choice and the left-right
check are ``reference/sgm.py``'s ``aggregate`` and ``post``, loaded from
that file by path; its ``box_sum`` sums the block.

For (N, H, W, 3) BGR pairs and candidates d in [minDisparity,
minDisparity + numDisparities) (target column x - d):

- gray = 0.299 R + 0.587 G + 0.114 B (ITU-R 601, in that order);
- prefilter: the horizontal Sobel derivative over the 3 x 3 window (the
  image's edge repeated), divided by 4 and clipped to +-preFilterCap, its
  six terms added left to right (+1 2 1 right column, -1 2 1 left);
- BT: for a row signal s, s-(x) = (s(x) + s(x - 1)) / 2 and s+(x) = (s(x)
  + s(x + 1)) / 2 (the edge repeated), and [s_min, s_max] the least and
  greatest of s-, s+ and s; with L the left and R the right prefiltered
  row and r = x - d held inside the image,
  C(x, d) = min(max(0, L(x) - R_max(r), R_min(r) - L(x)),
                max(0, R(r) - L_max(x), L_min(x) - R(r)));
- C summed over a blockSize square, the edge repeated (rows, then columns);
- the 8-path recurrence with P1 and P2 (``sgm.aggregate``), uniqueness,
  subpixel and the left-right check within disp12MaxDiff (``sgm.post``);
- speckles: q = floor(d / max(speckleRange * 16, 1)) of each int16 map;
  4-connected components of equal q, found by min-label propagation with
  pointer jumping (each pixel's label the least pixel index of its
  component); a component of fewer than speckleWindowSize pixels becomes
  (minDisparity - 1) x 16.

Where this departs from OpenCV's StereoSGBM, as the port does: the gray is
float, not rounded to 8 bits; the prefilter is the float derivative
clipped to +-preFilterCap, where OpenCV maps the integer Sobel response
into [0, 2 preFilterCap]; BT reads the prefiltered image only, where
OpenCV adds a BT term of the raw image; the block's cost is a plain sum of
the per-pixel costs, the edge repeated; P2 is fixed (no division by the
intensity step) and 8 paths run (OpenCV's default mode runs 5); the
uniqueness test rejects when another candidate more than one away has
S * 100 < S_best * (100 + uniquenessRatio); subpixel is a float quadratic
fit; the speckle filter groups pixels by their quantised disparity, where
cv2.filterSpeckles chains neighbours within maxDiff and leaves invalid
pixels out.

Costs are not whole numbers here, so bit-equality with the port rests on
the same operations in the same order: every sum above is written in the
port's order. ``dtype`` sets the precision of the float steps (float32 as
the port states; the control runs one step below, in bfloat16); the
speckle filter is integer in both.
"""

import importlib.util
import pathlib

import torch


def _load_sgm():
    path = pathlib.Path(__file__).with_name("sgm.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_reference_sgm_of_sgm_bt", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_sgm = _load_sgm()


def _edge_index(n, p, device):
    return torch.arange(-p, n + p, device=device).clamp(0, n - 1)


def xsobel(g, cap):
    """(N, H, W) horizontal Sobel derivative / 4, clipped to +-cap."""
    N, H, W = g.shape
    p = g[:, _edge_index(H, 1, g.device)][:, :, _edge_index(W, 1, g.device)]
    dx = (p[:, :-2, 2:] + 2 * p[:, 1:-1, 2:] + p[:, 2:, 2:]
          - p[:, :-2, :-2] - 2 * p[:, 1:-1, :-2] - p[:, 2:, :-2])
    return torch.clamp(dx / 4.0, -cap, cap)


def _interval(s):
    """(s_min, s_max) of (N, H, W) rows and their half-pixel neighbours."""
    W = s.shape[-1]
    x = torch.arange(W, device=s.device)
    lo = 0.5 * (s + s[..., (x - 1).clamp(min=0)])
    hi = 0.5 * (s + s[..., (x + 1).clamp(max=W - 1)])
    return (torch.minimum(torch.minimum(lo, hi), s),
            torch.maximum(torch.maximum(lo, hi), s))


def bt_cost(left, right, dmin, D):
    """(N, H, W, D) Birchfield-Tomasi cost of the prefiltered (N, H, W)
    rows; the right column x - d held inside the image."""
    W = left.shape[-1]
    dev = left.device
    src = (torch.arange(W, device=dev)[:, None]
           - torch.arange(dmin, dmin + D, device=dev)[None, :]).clamp(0, W - 1)
    r_min, r_max = _interval(right)
    l_min, l_max = _interval(left)
    lv = left[..., None]
    to_right = torch.maximum(lv - r_max[..., src], r_min[..., src] - lv)
    rv = right[..., src]
    to_left = torch.maximum(rv - l_max[..., None], l_min[..., None] - rv)
    return torch.minimum(to_right.clamp_min(0.0), to_left.clamp_min(0.0))


def speckles(maps, new_val, size, max_diff):
    """(N, H, W) int16 maps with every 4-connected component of equal
    floor(d / max(max_diff, 1)) of fewer than ``size`` pixels set to
    ``new_val``, each map alone."""
    N, H, W = maps.shape
    dev = maps.device
    q = torch.div(maps.long(), max(int(max_diff), 1), rounding_mode="floor")
    idx = torch.arange(N * H * W, device=dev).view(N, H, W)
    across = q[:, :, 1:] == q[:, :, :-1]
    down = q[:, 1:] == q[:, :-1]
    a = torch.cat([idx[:, :, 1:][across], idx[:, 1:][down]])
    b = torch.cat([idx[:, :, :-1][across], idx[:, :-1][down]])
    label = idx.flatten()
    while True:
        least = torch.minimum(label[a], label[b])
        new = label.scatter_reduce(0, a, least, "amin")
        new = new.scatter_reduce(0, b, least, "amin")
        new = new.scatter_reduce(0, label, new, "amin")  # the old roots
        while True:  # pointer jumping
            jumped = new[new]
            if torch.equal(jumped, new):
                break
            new = jumped
        if torch.equal(new, label):
            break
        label = new
    counts = torch.bincount(label, minlength=N * H * W)
    small = (counts[label] < size).view(N, H, W)
    return torch.where(small, torch.full_like(maps, new_val), maps)


def disparity(config, lefts, rights, device, dtype=torch.float32, block=4):
    """(N, H, W) int16 maps (disparity x 16) of the (N, H, W, 3) uint8
    pairs, computed on ``device`` in blocks of ``block`` frames."""
    p = config["params"]
    if p.get("costMethod", "bt") != "bt":
        raise ValueError("the BT SGM reference has the BT cost only")
    dmin, D, k = p["minDisparity"], p["numDisparities"], p["blockSize"]
    P1 = float(p.get("P1") or 8 * k * k)
    P2 = float(p.get("P2") or 32 * k * k)
    cap = float(p.get("preFilterCap", 63))
    size = p.get("speckleWindowSize", 0)
    out = []
    for b in range(0, len(lefts), block):
        grays = []
        for imgs in (lefts[b:b + block], rights[b:b + block]):
            t = torch.as_tensor(imgs, device=device)
            bl, gr, rd = (t[..., i].to(dtype) for i in range(3))
            grays.append(xsobel(0.299 * rd + 0.587 * gr + 0.114 * bl, cap))
        C = _sgm.box_sum(bt_cost(*grays, dmin, D), k)
        S = _sgm.aggregate(C, P1, P2, p.get("paths", 8))
        del C
        maps = _sgm.post(S, dmin, float(p.get("uniquenessRatio", 10)),
                         p.get("disp12MaxDiff", -1), p.get("subpixel", True))
        del S
        if size > 0:
            maps = speckles(maps, (dmin - 1) * 16, size,
                            p.get("speckleRange", 2) * 16)
        out.append(maps.cpu())
    return torch.cat(out).numpy()
