"""
sgm
===

Semi-Global Matching (Hirschmuller 2008), PyTorch port of
:mod:`simplestereo_tpu.passive.sgm`: the replacement for the reference's
``cv2.StereoSGBM`` calls (examples 008, 010 and 011).

The functions keep the JAX functions' names, arguments and the (H, W, D)
volume layout. They also take leading frame axes, (..., H, W[, D]): that
is how a frame stack runs, one launch set for the whole stack and the
per-frame results bit for bit.

- **Cost**: Birchfield-Tomasi on the clipped x-Sobel prefilter
  (:func:`_bt_cost`), census + Hamming distance (:func:`_census_cost`), or
  their sum, box-summed over the blockSize window (:func:`_box_sum`). On
  CUDA gray images the census cost (``"census"``, blockSize up to 591)
  runs the census kernels instead, :func:`.sgm_cuda.census_cost`, and the
  BT cost (``"bt"``, blockSize up to 11) the BT kernels,
  :func:`.sgm_cuda.bt_cost`; the torch code is the twin of both
  (:func:`_cost_kernel` holds the rule).
- **Aggregation**: :func:`.sgm_cuda.aggregate`, the hand-written CUDA
  kernel for a CUDA tensor and the plain twin :func:`.sgm_cuda._aggregate`
  for a CPU one.
- **Post**: winner-take-all, uniqueness, quadratic subpixel (x16), the
  left-right check from the same path sum, int16 (:func:`_sgm_post`): the
  post kernel :func:`.sgm_cuda.post` for a CUDA path sum, its twin, the
  torch code :func:`_sgm_post_plain`, for a CPU one;
  then, with ``speckleWindowSize > 0``, the speckle filter on the map's
  device (:meth:`StereoSGM._speckles`): the kernels of
  :func:`.speckle_cuda.filter_speckles` for a CUDA map, the host function
  :func:`filter_speckles`, their twin, for a CPU one.

The cost (gray included), the post and the speckle filter run in the spans
``sgm.cost``, ``sgm.post`` and ``sgm.speckle``
(:class:`..profiling.annotate`).

Every step does the JAX function's operations in its order, so on the CPU
the costs and the post are bit-equal to the JAX package's. The census
Hamming distance is the one place where the means differ: PyTorch has no
popcount and no uint32 shift on the CPU, so the twin's census code is one
int64 word (48 bits at most) and its bits are counted with shifts and
masks (a SWAR popcount); the kernels count them with the card's popcount.
Every census cost is a whole number below 2**24, so both give the same
float32 volume bit for bit.
"""

import numpy as np
import torch

from .._device import resolve_device
from ..profiling import annotate
from . import speckle_cuda
from ._entry import run_numpy
from .sgm_cuda import (BT_BLOCK_MAX, CENSUS_BLOCK_MAX, aggregate,
                       bt_cost, census_cost, post)

INVALID_SHIFT = 4  # output = disparity * 16 (OpenCV DISP_SHIFT convention)


def _luma(img):
    b, g, r = (img[..., i].to(torch.float32) for i in range(3))
    return 0.299 * r + 0.587 * g + 0.114 * b


def bgr_to_gray(img):
    """BGR -> single-channel luminance (ITU-R 601, cv2.cvtColor parity).
    An (H, W) image is gray already and passes through as float32."""
    if img.dim() == 2:
        return img.to(torch.float32)
    return _luma(img)


def _edge_pad(a, p, dims):
    """``a`` padded by ``p`` on both ends of each of ``dims``, repeating the
    edge (``mode="edge"``)."""
    for dim in dims:
        n = a.shape[dim]
        idx = torch.arange(-p, n + p, device=a.device).clamp(0, n - 1)
        a = a.index_select(dim, idx)
    return a


def _xsobel(gray, cap):
    """Horizontal Sobel derivative clipped to [-cap, cap] (prefilter)."""
    g = _edge_pad(gray, 1, (-2, -1))
    dx = (g[..., :-2, 2:] + 2 * g[..., 1:-1, 2:] + g[..., 2:, 2:]
          - g[..., :-2, :-2] - 2 * g[..., 1:-1, :-2] - g[..., 2:, :-2])
    return torch.clamp(dx / 4.0, -cap, cap)


def _shift_edge(a, d):
    """Shift (..., H, W) columns by d with edge fill: out[..., x] =
    a[..., x - d], the nearest edge column where x - d leaves the image.
    ``d`` is an int, or a (D,) tensor of shifts, which gives (..., H, W, D)
    in one gather.

    Off-image candidates are masked to invalid in _sgm_post, so the fill
    only keeps shapes static for any d (|d| may exceed W, minDisparity may
    be negative)."""
    W = a.shape[-1]
    xs = torch.arange(W, device=a.device)
    cols = xs - d if isinstance(d, int) else xs[:, None] - d[None, :]
    return a[..., cols.clamp(0, W - 1)]


def _candidates(min_disp, num_disp, device):
    return torch.arange(min_disp, min_disp + num_disp, device=device)


def _interval(a):
    """(min, max) of a row signal and its two half-pixel interpolants."""
    am = 0.5 * (a + torch.cat([a[..., :1], a[..., :-1]], dim=-1))
    ap = 0.5 * (a + torch.cat([a[..., 1:], a[..., -1:]], dim=-1))
    return (torch.minimum(torch.minimum(am, ap), a),
            torch.maximum(torch.maximum(am, ap), a))


def _bt_cost(ref, tgt, min_disp, num_disp):
    """Birchfield-Tomasi cost volume (..., H, W, D); tgt column = x - d."""
    ds = _candidates(min_disp, num_disp, ref.device)
    t_min, t_max = _interval(tgt)
    r_min, r_max = _interval(ref)
    ref = ref[..., None]
    c_rt = torch.maximum(ref - _shift_edge(t_max, ds),
                         _shift_edge(t_min, ds) - ref)
    tgt = _shift_edge(tgt, ds)
    c_tr = torch.maximum(tgt - r_max[..., None], r_min[..., None] - tgt)
    return torch.minimum(c_rt.clamp_min(0.0), c_tr.clamp_min(0.0))


def _census_words(gray, win):
    """Census transform of (..., H, W) gray: bit k of the int64 code is 1
    iff the k-th window neighbour (row-major, centre skipped) is brighter
    than the centre (Zabih-Woodfill 1994). The JAX function packs the same
    bits 24 to a uint32 word: its word w is bits 24w .. 24w+23 here."""
    H, W = gray.shape[-2:]
    p = win // 2
    g = _edge_pad(gray, p, (-2, -1))
    code = torch.zeros(gray.shape, dtype=torch.int64, device=gray.device)
    k = 0
    for di in range(-p, p + 1):
        for dj in range(-p, p + 1):
            if di == 0 and dj == 0:
                continue
            bit = g[..., p + di:p + di + H, p + dj:p + dj + W] > gray
            code = code | (bit.to(torch.int64) << k)
            k += 1
    return code


def _popcount(x):
    """Number of set bits of each non-negative int64 (SWAR bit count)."""
    x = x - ((x >> 1) & 0x5555555555555555)
    x = (x & 0x3333333333333333) + ((x >> 2) & 0x3333333333333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    x = x + (x >> 32)
    return x & 0x7F


def _census_cost(ref, tgt, min_disp, num_disp, win):
    """Hamming-distance cost volume (..., H, W, D) between census codes;
    tgt column = x - d. float32, range [0, win*win - 1]."""
    rw = _census_words(ref, win)
    tw = _shift_edge(_census_words(tgt, win),
                     _candidates(min_disp, num_disp, tgt.device))
    return _popcount(rw[..., None] ^ tw).to(torch.float32)


def _box_sum(vol, k):
    """Sum over a k x k spatial window (edge-padded) of (..., H, W, D).

    Direct k-fold shifted adds in the JAX function's order, not a cumsum
    difference: a pixel's sum depends on its k x k neighbourhood only."""
    if k <= 1:
        return vol
    p = k // 2
    H, W = vol.shape[-3:-1]
    v = _edge_pad(vol, p, (-3, -2))
    s = v[..., 0:H, :, :]
    for di in range(1, k):
        s = s + v[..., di:di + H, :, :]
    out = s[..., 0:W, :]
    for dj in range(1, k):
        out = out + s[..., dj:dj + W, :]
    return out


def _edge_fill_rows(ext, valid, row_axis=0):
    """Replace invalid rows (beyond the true image boundary in a
    row-sharded halo block) with the nearest valid row along ``row_axis``
    — the sharded twin of ``mode="edge"`` padding."""
    first, last = _valid_range(valid)
    idx = torch.arange(valid.shape[0], device=ext.device).clamp(first, last)
    return ext.index_select(row_axis, idx)


def _valid_range(valid):
    """First and last True row of a bool row mask, as 0-dim tensors on its
    device (0 and n - 1 where no row is True)."""
    v = valid.to(torch.uint8)
    return torch.argmax(v), valid.shape[0] - 1 - torch.argmax(v.flip(0))


def _cost_kernel(cost_method, device, block_size):
    """The hand kernel pair that computes a cost on ``device``: "census"
    (:func:`.sgm_cuda.census_cost`) for ``"census"`` up to
    ``CENSUS_BLOCK_MAX``, "bt" (:func:`.sgm_cuda.bt_cost`) for ``"bt"`` up
    to ``BT_BLOCK_MAX``, on a CUDA device; None, the torch code, in every
    other case. ``"bt+census"`` stays on the torch code: no benchmark cell
    runs it."""
    if torch.device(device).type != "cuda":
        return None
    if cost_method == "census" and block_size <= CENSUS_BLOCK_MAX:
        return "census"
    if cost_method == "bt" and block_size <= BT_BLOCK_MAX:
        return "bt"
    return None


def _cost_from_gray(gray1, gray2, *, min_disp, num_disp, block_size,
                    prefilter_cap, cost_method="bt", census_window=5,
                    row_valid=None):
    """:func:`_sgm_cost` of (..., H, W) float32 gray images.

    Where :func:`_cost_kernel` names a kernel pair, runs it
    (``row_valid`` as the rows its box reads); every other case the torch
    code below, its twin."""
    kernel = _cost_kernel(cost_method, gray1.device, block_size)
    if kernel is not None:
        rows = (None if row_valid is None else
                torch.stack(_valid_range(row_valid)).to(torch.int32))
        if kernel == "census":
            return census_cost(gray1, gray2, min_disp, num_disp,
                               census_window, block_size, rows)
        return bt_cost(gray1, gray2, min_disp, num_disp, prefilter_cap,
                       block_size, rows)
    C = None
    if cost_method in ("bt", "bt+census"):
        g1 = _xsobel(gray1, prefilter_cap)
        g2 = _xsobel(gray2, prefilter_cap)
        C = _bt_cost(g1, g2, min_disp, num_disp)
    if cost_method in ("census", "bt+census"):
        Cc = _census_cost(gray1, gray2, min_disp, num_disp, census_window)
        if C is None:
            C = Cc
        else:
            nbits = census_window * census_window - 1
            C = C + Cc * (2.0 * prefilter_cap / nbits)
    if C is None:
        raise ValueError(
            "costMethod must be 'bt', 'census' or 'bt+census'!")
    if row_valid is not None:
        C = _edge_fill_rows(C, row_valid, row_axis=C.dim() - 3)
    return _box_sum(C, block_size)


def _sgm_cost(img1, img2, *, min_disp, num_disp, block_size,
              prefilter_cap, cost_method="bt", census_window=5,
              row_valid=None):
    """Cost volume (H, W, D) of one frame.

    "bt": Sobel prefilter + Birchfield-Tomasi; "census": census/Hamming
    on raw luminance; "bt+census": their sum with census scaled to BT's
    range (max 2*prefilter_cap over max win*win-1 bits).

    ``row_valid``: bool mask of the rows inside the true image (row-sharded
    blocks). The pre-box cost of an invalid row is replaced by the nearest
    valid row's, so the box filter sees the edge padding of a whole frame.
    """
    return _cost_from_gray(
        bgr_to_gray(img1), bgr_to_gray(img2), min_disp=min_disp,
        num_disp=num_disp, block_size=block_size,
        prefilter_cap=prefilter_cap, cost_method=cost_method,
        census_window=census_window, row_valid=row_valid)


def _sgm_post(S, *, min_disp, num_disp, uniqueness, disp12_max_diff,
              subpixel):
    """WTA + uniqueness + subpixel + LR check on a (..., H, W, D) path sum.
    Returns (..., H, W) int16 disparity x16 on S's device: a CUDA S runs the
    post kernel (:func:`.sgm_cuda.post`), a CPU one the torch code
    (:func:`_sgm_post_plain`), its twin; any other device raises."""
    kw = dict(min_disp=min_disp, num_disp=num_disp, uniqueness=uniqueness,
              disp12_max_diff=disp12_max_diff, subpixel=subpixel)
    if S.device.type == "cuda":
        return post(S, **kw)
    if S.device.type != "cpu":
        raise ValueError(f"no SGM post for device {S.device}")
    return _sgm_post_plain(S, **kw)


def _sgm_post_plain(S, *, min_disp, num_disp, uniqueness, disp12_max_diff,
                    subpixel):
    """:func:`_sgm_post` in torch operations, on any device (the JAX
    function's operations in its order)."""
    H, W = S.shape[-3:-1]
    dev = S.device
    # Mask candidates whose target column x - d falls outside the image
    # (both ends: d > x for positive d, x - d > W-1 for negative d).
    xs = torch.arange(W, device=dev)[:, None]
    ds = _candidates(min_disp, num_disp, dev)[None, :]
    S = torch.where((xs - ds >= 0) & (xs - ds <= W - 1), S, torch.inf)

    best = torch.argmin(S, dim=-1)
    s_best = torch.amin(S, dim=-1)
    valid = torch.isfinite(s_best)

    # Uniqueness: reject if some non-neighbour candidate is within ratio.
    if uniqueness > 0:
        dd = torch.arange(num_disp, device=dev)
        non_neigh = (dd - best[..., None]).abs() > 1
        s2 = torch.amin(torch.where(non_neigh, S, torch.inf), dim=-1)
        valid &= ~(s2 * 100.0 < s_best * (100.0 + uniqueness))

    # Subpixel: quadratic fit around the minimum, x16 fixed point.
    disp16 = (best + min_disp).to(torch.float32) * 16.0
    if subpixel:
        bm1 = torch.gather(S, -1, (best - 1).clamp(min=0)[..., None])[..., 0]
        bp1 = torch.gather(
            S, -1, (best + 1).clamp(max=num_disp - 1)[..., None])[..., 0]
        bm1 = torch.where(torch.isfinite(bm1), bm1, s_best)
        bp1 = torch.where(torch.isfinite(bp1), bp1, s_best)
        denom = bm1 + bp1 - 2.0 * s_best
        delta = torch.where(denom > 1e-6, (bm1 - bp1) / (2.0 * denom), 0.0)
        delta = torch.clamp(delta, -0.5, 0.5)
        interior = (best > 0) & (best < num_disp - 1)
        disp16 = disp16 + torch.where(interior, delta, 0.0) * 16.0

    # Left-right check from the same aggregated volume:
    # right disparity at xr = argmin_d S(y, xr + d, d).
    if disp12_max_diff >= 0:
        cols = (xs + ds).clamp(0, W - 1)                    # (W, D)
        S_r = torch.gather(S, -2, cols.expand(S.shape))
        # Mask right-view candidates whose left column xr + d is off-image
        # at either end (xr + d < 0 happens with negative minDisparity).
        S_r = torch.where((xs + ds >= 0) & (xs + ds <= W - 1), S_r,
                          torch.inf)
        disp_r = torch.argmin(S_r, dim=-1) + min_disp        # (..., H, W)
        match_col = (torch.arange(W, device=dev)
                     - (best + min_disp)).clamp(0, W - 1)
        lr = torch.gather(disp_r, -1, match_col)
        valid &= (lr - (best + min_disp)).abs() <= disp12_max_diff

    out = torch.where(valid, disp16, float((min_disp - 1) * 16))
    return torch.round(out).to(torch.int16)


def _gray_frames(imgs):
    """(B, H, W) gray or (B, H, W, C) BGR stack -> (B, H, W) float32."""
    return _luma(imgs) if imgs.dim() == 4 else imgs.to(torch.float32)


def _sgm_disparity_batch(imgs1, imgs2, *, min_disp, num_disp, block_size,
                         P1, P2, paths, prefilter_cap, uniqueness,
                         disp12_max_diff, subpixel, cost_method="bt",
                         census_window=5):
    """(B, H, W[, 3]) stacks -> (B, H, W) int16 disparity x16, on the
    stacks' device. The frame axis is written out through every stage; the
    aggregation is one launch set for the whole stack (the CUDA kernel for
    a CUDA stack, the twin for a CPU one)."""
    with annotate("sgm.cost"):
        C = _cost_from_gray(
            _gray_frames(imgs1), _gray_frames(imgs2), min_disp=min_disp,
            num_disp=num_disp, block_size=block_size,
            prefilter_cap=prefilter_cap, cost_method=cost_method,
            census_window=census_window)
    S = aggregate(C.contiguous(), P1, P2, paths)
    del C
    with annotate("sgm.post"):
        return _sgm_post(S, min_disp=min_disp, num_disp=num_disp,
                         uniqueness=uniqueness,
                         disp12_max_diff=disp12_max_diff, subpixel=subpixel)


def _sgm_disparity(img1, img2, *, min_disp, num_disp, block_size, P1, P2,
                   paths, prefilter_cap, uniqueness, disp12_max_diff,
                   subpixel, cost_method="bt", census_window=5):
    """(H, W[, 3]) pair -> (H, W) int16 disparity x16 on the pair's device:
    :func:`_sgm_disparity_batch` of a stack of one."""
    return _sgm_disparity_batch(
        img1[None], img2[None], min_disp=min_disp, num_disp=num_disp,
        block_size=block_size, P1=P1, P2=P2, paths=paths,
        prefilter_cap=prefilter_cap, uniqueness=uniqueness,
        disp12_max_diff=disp12_max_diff, subpixel=subpixel,
        cost_method=cost_method, census_window=census_window)[0]


def filter_speckles(disparity, new_val, max_speckle_size, max_diff):
    """Invalidate small connected blobs of similar disparity (host-side).

    A copy of :func:`simplestereo_tpu.passive.sgm.filter_speckles` (numpy
    and scipy), and the twin of the card's kernels
    (:func:`.speckle_cuda.filter_speckles`). Parity target: the
    ``cv2.filterSpeckles`` post-pass SGBM users apply. Connected components
    (4-connectivity) of equal ``floor(d / max(max_diff, 1))``; components
    smaller than max_speckle_size become new_val. (OpenCV chains
    neighbours that differ by <= max_diff instead.)
    """
    from scipy.ndimage import label

    d = np.asarray(disparity).copy()
    # Quantize into difference-bounded regions: two neighbors belong to the
    # same blob if |d1 - d2| <= max_diff.
    q = np.floor_divide(d.astype(np.int64), max(int(max_diff), 1))
    blobs = np.zeros_like(d, dtype=np.int64)
    n_total = 0
    for v in np.unique(q):
        lab, n = label(q == v)
        blobs = np.where(lab > 0, lab + n_total, blobs)
        n_total += n
    counts = np.bincount(blobs.ravel())
    small = counts[blobs] < max_speckle_size
    d[small & (blobs > 0)] = new_val
    return d


class StereoSGM:
    """Semi-Global Matcher with a ``cv2.StereoSGBM``-compatible surface.

    Same constructor, defaults, validation and results as
    :class:`simplestereo_tpu.passive.StereoSGM`, plus ``device``: the
    matcher runs there (``"cuda"``: the aggregation kernel; ``"cpu"``: the
    plain PyTorch twin). A CUDA device without a card raises. There is no
    ``aggregator`` argument: the device decides.

    ``compute`` returns int16 disparity x16 (OpenCV's fixed point).
    ``paths`` (4 or 8) replaces OpenCV's ``mode``. ``costMethod``: "bt"
    (Birchfield-Tomasi on the Sobel prefilter, default), "census" (census
    transform + Hamming distance over a ``censusWindow`` square window) or
    "bt+census". P1 and P2 default to 8 and 32 times blockSize squared.
    """

    def __init__(self, minDisparity=0, numDisparities=16, blockSize=3,
                 P1=0, P2=0, disp12MaxDiff=-1, preFilterCap=63,
                 uniquenessRatio=10, speckleWindowSize=0, speckleRange=2,
                 paths=8, costMethod="bt", censusWindow=5, device="cuda"):
        if numDisparities <= 0:
            raise ValueError("numDisparities must be positive!")
        if blockSize < 1 or blockSize % 2 == 0:
            raise ValueError("blockSize must be a positive odd number!")
        if costMethod not in ("bt", "census", "bt+census"):
            raise ValueError(
                "costMethod must be 'bt', 'census' or 'bt+census'!")
        if censusWindow not in (3, 5, 7):
            raise ValueError("censusWindow must be 3, 5 or 7!")
        self.minDisparity = minDisparity
        self.numDisparities = numDisparities
        self.blockSize = blockSize
        self.P1 = P1 if P1 > 0 else 8 * blockSize * blockSize
        self.P2 = P2 if P2 > 0 else 32 * blockSize * blockSize
        self.disp12MaxDiff = disp12MaxDiff
        self.preFilterCap = preFilterCap
        self.uniquenessRatio = uniquenessRatio
        self.speckleWindowSize = speckleWindowSize
        self.speckleRange = speckleRange
        self.paths = paths
        self.costMethod = costMethod
        self.censusWindow = censusWindow
        self.device = resolve_device(device)

    def _kwargs(self, subpixel):
        return dict(
            min_disp=self.minDisparity, num_disp=self.numDisparities,
            block_size=self.blockSize, P1=float(self.P1), P2=float(self.P2),
            paths=self.paths, prefilter_cap=float(self.preFilterCap),
            uniqueness=float(self.uniquenessRatio),
            disp12_max_diff=self.disp12MaxDiff, subpixel=subpixel,
            cost_method=self.costMethod, census_window=self.censusWindow)

    def _speckles(self, disp):
        """The speckle filter of (..., H, W) int16 maps, each map alone,
        where they lie: a CUDA tensor on the card's kernels
        (:func:`.speckle_cuda.filter_speckles`), a CPU tensor or a numpy
        array on the host (:func:`filter_speckles`), of the same type."""
        args = ((self.minDisparity - 1) * 16, self.speckleWindowSize,
                self.speckleRange * 16)
        if isinstance(disp, torch.Tensor) and disp.device.type == "cuda":
            return speckle_cuda.filter_speckles(disp, *args)
        host = np.asarray(disp)
        maps = host.reshape((-1,) + host.shape[-2:])
        out = np.stack([filter_speckles(d, *args) for d in maps]).reshape(
            host.shape)
        return torch.as_tensor(out) if isinstance(disp, torch.Tensor) else out

    def _match(self, imgs1, imgs2, subpixel=True):
        """(B, H, W) int16 maps of (B, H, W[, 3]) stacks on their device,
        speckles filtered there (span ``sgm.speckle``) where
        ``speckleWindowSize > 0``."""
        out = _sgm_disparity_batch(imgs1, imgs2, **self._kwargs(subpixel))
        if self.speckleWindowSize > 0:
            with annotate("sgm.speckle"):
                out = self._speckles(out)
        return out

    def compute(self, img1, img2, subpixel=True):
        """(H, W) int16 disparity x16 of an (H, W) gray or (H, W, 3) BGR
        pair, referred to img1. Numpy arrays run on the matcher's device
        and give numpy; tensors run on img1's device and give a tensor
        there."""
        if not isinstance(img1, torch.Tensor):
            img1 = np.ascontiguousarray(img1)
            img2 = np.ascontiguousarray(img2)
            _check_pair(img1.shape, img2.shape)
            return run_numpy(
                lambda a, b: self._match(a[None], b[None], subpixel)[0],
                img1, img2, self.device)
        img2 = torch.as_tensor(img2, device=img1.device)
        _check_pair(img1.shape, img2.shape)
        with annotate("match"):
            return self._match(img1[None], img2[None], subpixel)[0]

    def computeBatch(self, imgs1, imgs2, subpixel=True):
        """Batched :meth:`compute`: (B, H, W[, 3]) stacks -> (B, H, W).
        One aggregation launch set for the whole stack; the result equals
        per-frame :meth:`compute` bit for bit."""
        imgs1 = np.ascontiguousarray(imgs1)
        imgs2 = np.ascontiguousarray(imgs2)
        # (B, H, 3)-shaped gray batches are indistinguishable from a
        # single color image — reject them to catch the common mistake of
        # passing one frame.
        if (imgs1.shape != imgs2.shape or imgs1.ndim not in (3, 4)
                or (imgs1.ndim == 3 and imgs1.shape[-1] == 3)
                or (imgs1.ndim == 4 and imgs1.shape[-1] != 3)):
            raise ValueError(
                "Batches must be (B, H, W) or (B, H, W, 3) stacks with "
                "identical shapes!")
        return run_numpy(self._match, imgs1, imgs2, self.device,
                         subpixel=subpixel)


def _check_pair(shape1, shape2):
    if shape1 != shape2 or len(shape1) not in (2, 3):
        raise ValueError("Images must be (H, W) or (H, W, 3) with "
                         "identical shapes!")


# cv2-compatible constructor alias mirroring StereoSGBM_create.
def StereoSGBM_create(**kwargs):
    return StereoSGM(**kwargs)
