"""
gsw
===

Geodesic Support-Weight matcher, PyTorch port of
:mod:`simplestereo_tpu.passive.gsw`: the plain twin of the GSW kernel
(the CPU path, and the oracle the CUDA kernel is checked against), the
mutual-information (MI) cost pieces, the host-side cost-method probe, and
the public :func:`gsw_disparity` / :class:`StereoGSW`.

- support weights in closed form, ``exp(-||c_i - c_center||_2 / gamma)``
  (:func:`_gsw_weights`; the reference's iterated chamfer recursion
  collapses to it, so ``iterations`` has no effect), exactly 0 for window
  pixels outside the image;
- matching cost: the unnormalized weighted sum over the window of
  ``min(fMax, ||dBGR||_2)`` (:func:`_capdist_volume`), or of a prebuilt
  MI volume, optionally divided by the summed weight of the
  candidate-valid window pixels (``normalize``);
- the first minimum (smallest disparity) wins; a pixel with an empty
  candidate range returns its own column.

The twin works on one frame in the JAX package's (H, W[, C]) layout. It
walks the window offsets in chunks (:func:`_gsw_cost`), so that a
1280x720 frame at window 23 never holds the whole (win^2, H, W) stack.

The MI table takes an exact histogram (``bincount``) and the MI maps are
a gather, where the JAX package used one-hot matrix products to suit the
TPU: the counts and the selected table entries are the same, and no
matrix product (with its TF32 hazard on a GPU) is left on the path.
"""

import math

import numpy as np
import torch

from .._device import resolve_device

# Elements of one (offsets, H, W, D) chunk of the twin's window walk.
_TWIN_CHUNK = 1 << 25


def _color_dist(a, b):
    return torch.sqrt(((a - b) ** 2).sum(-1))


def _parzen(h, sigma=1.0, radius=3, dims=1):
    """Gaussian (Parzen window) smoothing of the last ``dims`` axes (1 or
    2) of ``h``: numpy-style ``convolve(mode="same")`` along each axis,
    zero outside, written as shifted sums (no convolution library call,
    so no TF32 on a GPU). The taps are symmetric, so correlation and
    convolution are the same. An axis must hold at least ``2*radius+1``
    entries: below that "same" means something else (see
    :func:`_mi_cost_table`)."""
    x = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=h.device)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    k = k / k.sum()

    def along_last(a):
        n = a.shape[-1]
        p = torch.nn.functional.pad(a, (radius, radius))
        out = k[0] * p[..., 0:n]
        for t in range(1, 2 * radius + 1):
            out = out + k[t] * p[..., t:t + n]
        return out

    out = along_last(h)
    if dims == 2:
        out = along_last(out.transpose(-1, -2)).transpose(-1, -2)
    return out


def _mi_cost_table(q1, q2, disp, valid, *, bins):
    """Per-pixel MI cost table (..., bins, bins) from the current matching.

    q1, q2 : (..., H, W) int gray levels; disp (..., H, W) int; valid bool.
    Hirschmuller 2008 §2.1: h12 = -g(log(g(P12))), h_k = -g(log(g(P_k)))
    from the marginals; C(i, j) = h12(i, j) - h1(i) - h2(j) = -mi(i, j).
    The joint histogram is an exact count per frame of the leading axes.
    """
    if bins < 7:
        # The 7-tap Parzen window would outgrow the table (the JAX package
        # fails there with a shape error in its one-hot cost maps).
        raise ValueError("bins must be >= 7 for the MI cost!")
    lead = q1.shape[:-2]
    W = q1.shape[-1]
    dev = q1.device
    disp = disp.long()
    xs = torch.arange(W, device=dev)
    src = xs - disp
    q2m = torch.gather(q2.long(), -1, src.clamp(0, W - 1))
    ok = valid & (src >= 0) & (src <= W - 1)

    nf = math.prod(lead)
    frame = torch.arange(nf, device=dev).view(lead + (1, 1))
    idx = (frame * bins + q1.long()) * bins + q2m
    dump = nf * bins * bins  # pairs that do not count land past the end
    hist = torch.bincount(torch.where(ok, idx, dump).flatten(),
                          minlength=dump + 1)[:dump]
    hist = hist.view(lead + (bins, bins)).to(torch.float32)

    eps = 1e-7
    n = torch.clamp(hist.sum((-2, -1), keepdim=True), min=1.0)
    P12 = hist / n
    h12 = -_parzen(torch.log(_parzen(P12, dims=2) + eps), dims=2)
    P1 = P12.sum(-1)
    P2 = P12.sum(-2)

    def h_marg(p):
        return -_parzen(torch.log(_parzen(p) + eps))

    return h12 - h_marg(P1)[..., :, None] - h_marg(P2)[..., None, :]


def _window_shifts(img, win_size, fill, offsets=None):
    """(n, H, W[, C]) stack of the (H, W[, C]) image sampled at window
    offsets (``fill`` in out-of-image positions). Offset o is row
    ``o // win_size``, column ``o % win_size`` of the window; ``offsets``
    defaults to all ``win_size**2`` of them."""
    H, W = img.shape[:2]
    pad = win_size // 2
    widths = (0, 0) * (img.dim() - 2) + (pad, pad, pad, pad)
    p = torch.nn.functional.pad(img.to(torch.float32), widths, value=fill)
    if offsets is None:
        offsets = range(win_size * win_size)
    return torch.stack([p[o // win_size:o // win_size + H,
                          o % win_size:o % win_size + W] for o in offsets])


def _gsw_weights(img, win_size, iterations, gamma, offsets=None):
    """Support weights (n, H, W): ``exp(-||c_i - c_center||_2 / gamma)``
    at the window ``offsets`` (default: all), 0 for window pixels outside
    the image.

    The closed form of the reference's iterated chamfer sweep: its edge
    relation is the direct BGR distance, which satisfies the triangle
    inequality, so the shortest path to the centre is always the direct
    hop (see :func:`simplestereo_tpu.passive.gsw._gsw_weights`).
    ``iterations`` has no effect, as in the reference.
    """
    S = _window_shifts(img, win_size, math.inf, offsets)
    d = _color_dist(S, img.to(torch.float32)[None])
    return torch.exp(-d / gamma)  # an inf distance gives exactly 0


def _lattice(win_size, step):
    """Window offsets on the ``step`` lattice anchored at the centre."""
    pad = win_size // 2
    return [o for o in range(win_size * win_size)
            if (o // win_size - pad) % step == 0
            and (o % win_size - pad) % step == 0]


def _shift_tgt(a, d):
    """Target-frame column shift: out(y, x) = a(y, x - d), zero fill.

    Handles either sign and |d| >= W (candidate validity is masked by the
    callers)."""
    W = a.shape[1]
    if d == 0:
        return a
    z = torch.zeros_like(a[:, :min(abs(d), W)])
    if d > 0:
        return torch.cat([z, a[:, :W - min(d, W)]], dim=1)
    return torch.cat([a[:, min(-d, W):], z], dim=1)


def _candidate_ok(W, min_disp, max_disp, device):
    """(D, W) bool: 0 <= x - d <= W - 1."""
    xs = torch.arange(W, device=device)
    ds = torch.arange(min_disp, max_disp + 1, device=device)
    src = xs[None, :] - ds[:, None]
    return (src >= 0) & (src <= W - 1)


def _capdist_volume(f1, f2, min_disp, max_disp, f_max):
    """(D, H, W) ``min(fMax, ||left(y,x) - right(y,x-d)||_2)``, 0 where
    column ``x - d`` leaves the image."""
    ok = _candidate_ok(f1.shape[1], min_disp, max_disp, f1.device)
    vols = [torch.clamp(_color_dist(f1, _shift_tgt(f2, d)), max=f_max)
            for d in range(min_disp, max_disp + 1)]
    return torch.where(ok[:, None, :], torch.stack(vols), 0.0)


def _gsw_cost(img1, img2, *, win_size, min_disp, max_disp, gamma, f_max,
              iterations=1, normalize=False, step=1, vol=None):
    """Masked GSW cost volume (D, H, W) float32 of one (H, W, 3) frame:
    inf where column ``x - d`` leaves the image.

    ``vol``: a prebuilt (D, H, W) cost volume, zero where the candidate
    column leaves the image (the MI path); ``img2`` is then unused.
    Otherwise the capped colour distance to ``img2``. ``step`` keeps the
    window offsets on the lattice anchored at the centre (the others
    weigh nothing). ``normalize`` divides by the summed weight of the
    candidate-valid window pixels.
    """
    H, W = img1.shape[:2]
    D = max_disp - min_disp + 1
    f1 = img1.to(torch.float32)
    if vol is None:
        vol = _capdist_volume(f1, img2.to(torch.float32), min_disp,
                              max_disp, f_max)
    ok = _candidate_ok(W, min_disp, max_disp, f1.device)        # (D, W)
    vol = vol.permute(1, 2, 0)                                  # (H, W, D)
    V = ok.T.to(torch.float32).expand(H, W, D)

    offs = _lattice(win_size, step)
    chunk = max(1, _TWIN_CHUNK // (H * W * D))
    num = torch.zeros((H, W, D), dtype=torch.float32, device=f1.device)
    den = torch.zeros_like(num) if normalize else None
    for s in range(0, len(offs), chunk):
        o = offs[s:s + chunk]
        w = _gsw_weights(f1, win_size, iterations, gamma, o)[..., None]
        num = num + (w * _window_shifts(vol, win_size, 0.0, o)).sum(0)
        if normalize:
            den = den + (w * _window_shifts(V, win_size, 0.0, o)).sum(0)
    c = num / torch.clamp(den, min=1e-12) if normalize else num
    return torch.where(ok.T[None], c, torch.inf).permute(2, 0, 1)


def _argmin_disp(cost, min_disp):
    """First-minimum disparity (..., H, W) int32 of a (..., D, H, W)
    volume (an all-inf column gives ``min_disp``)."""
    return (torch.argmin(cost, dim=-3) + min_disp).to(torch.int32)


def _quantize_gray(img, bins):
    """BGR (..., H, W, 3) -> gray level index in [0, bins); a 2-D image is
    gray already."""
    img = img.to(torch.float32)
    g = (0.114 * img[..., 0] + 0.587 * img[..., 1] + 0.299 * img[..., 2]
         if img.dim() >= 3 else img)
    return torch.clamp((g * bins / 256.0).to(torch.int32), 0, bins - 1)


def _mi_cost_maps(q1, q2, table, *, min_disp, max_disp, bins):
    """MI cost volume (..., D, H, W): ``M_d(y, x) = T'[q1(y,x),
    q2(y,x-d)]``, 0 where column ``x - d`` leaves the image, with ``T' =
    table - min(table)`` per frame (non-negative, so zero-padded window
    pixels stay neutral). A gather: bit-identical to the JAX package's
    one-hot product form."""
    W = q1.shape[-1]
    dev = q1.device
    flat_t = table - table.amin((-2, -1), keepdim=True)
    ok = _candidate_ok(W, min_disp, max_disp, dev)              # (D, W)
    xs = torch.arange(W, device=dev)
    src = (xs[None, :] - torch.arange(min_disp, max_disp + 1,
                                      device=dev)[:, None]).clamp(0, W - 1)
    q2s = q2.long()[..., src].movedim(-2, -3)                   # (.., D, H, W)
    idx = q1.long()[..., None, :, :] * bins + q2s
    vals = torch.gather(flat_t.flatten(-2)[..., None, :].expand(
        idx.shape[:-2] + (bins * bins,)), -1, idx.flatten(-2))
    return torch.where(ok[:, None, :], vals.view(idx.shape), 0.0)


def _mi_volume(q1, q2, disp_prev, *, min_disp, max_disp, bins):
    """MI cost volume (..., D, H, W) from the previous matching: the table
    over the pairs with ``disp_prev >= 0``, then its maps."""
    table = _mi_cost_table(q1, q2, disp_prev, disp_prev >= 0, bins=bins)
    return _mi_cost_maps(q1, q2, table, min_disp=min_disp,
                         max_disp=max_disp, bins=bins)


#: EMD threshold (gray levels) above which ``cost_method="auto"`` picks
#: MI (a copy of :data:`simplestereo_tpu.passive.gsw.MI_AUTO_THRESHOLD`,
#: validated on Tsukuba there).
MI_AUTO_THRESHOLD = 5.0


def radiometric_divergence(img1, img2, bins=64):
    """Radiometric mismatch probe: 1-D earth-mover's distance between the
    two images' grayscale histograms, in gray levels (0-255 scale).

    A copy of :func:`simplestereo_tpu.passive.gsw.radiometric_divergence`
    (numpy, host side). BGR(A) inputs of any leading shape are averaged
    over channels; a (B, H, W) gray batch is not.
    """
    a = np.asarray(img1, np.float64)
    b = np.asarray(img2, np.float64)
    if a.ndim >= 3 and a.shape[-1] in (3, 4):
        a = a.mean(-1)
    if b.ndim >= 3 and b.shape[-1] in (3, 4):
        b = b.mean(-1)
    ha, _ = np.histogram(a, bins=bins, range=(0, 255))
    hb, _ = np.histogram(b, bins=bins, range=(0, 255))
    pa = ha / max(ha.sum(), 1)
    pb = hb / max(hb.sum(), 1)
    return float(np.abs(np.cumsum(pa - pb)).sum() * (255.0 / bins))


def resolve_cost_method(img1, img2, cost_method,
                        threshold=MI_AUTO_THRESHOLD, step=1):
    """Resolve ``cost_method="auto"`` to "sd" or "mi" via the
    radiometric-divergence probe; passes "sd"/"mi" through unchanged.
    ``step > 1`` resolves auto to "sd" without probing (MI does not take
    the subsampled scan). A copy of
    :func:`simplestereo_tpu.passive.gsw.resolve_cost_method`."""
    if cost_method != "auto":
        return cost_method
    if step > 1:
        return "sd"
    return ("mi" if radiometric_divergence(img1, img2) > threshold
            else "sd")


def gsw_disparity_batch(imgs1, imgs2, win_size=11, max_disp=16, min_disp=0,
                        gamma=10.0, f_max=120.0, iterations=3,
                        consistent=False, cost_method="sd", bins=20,
                        mi_iterations=2, normalize=False, step=1,
                        disp0=None):
    """GSW disparity of a (B, H, W, 3) BGR tensor stack on its device:
    (B, H, W) int16, bit-identical to per-frame :func:`gsw_disparity`.

    Parameters as :func:`simplestereo_tpu.passive.gsw.gsw_disparity`,
    without ``engine`` and ``interpret``: a CUDA stack runs the kernel, a
    CPU stack the plain twin. ``disp0``: the (H, W) bootstrap field of
    the MI cost, shared by the stack; by default drawn from a
    ``torch.Generator`` seeded 0 (``jax.random`` cannot be reproduced, so
    a caller that needs the JAX package's field passes it in).
    ``normalize`` is inert for MI, as in the JAX package.
    """
    from .gsw_cuda import gsw_disparity_cuda_batch, gsw_mi_disparity_cuda_batch

    if step < 1:
        raise ValueError("step must be >= 1!")
    if cost_method == "auto":  # the probe reads the frames on the host
        cost_method = resolve_cost_method(imgs1.cpu().numpy(),
                                          imgs2.cpu().numpy(), cost_method,
                                          step=step)
    if step > 1 and cost_method == "mi":
        raise ValueError("step > 1 requires cost_method='sd'!")
    if cost_method == "mi":
        return gsw_mi_disparity_cuda_batch(
            imgs1, imgs2, win_size=win_size, max_disp=max_disp,
            min_disp=min_disp, gamma=gamma, bins=bins,
            mi_iterations=mi_iterations, consistent=consistent, disp0=disp0)
    return gsw_disparity_cuda_batch(
        imgs1, imgs2, win_size=win_size, max_disp=max_disp,
        min_disp=min_disp, gamma=gamma, f_max=f_max, consistent=consistent,
        step=step, normalize=normalize)


def gsw_disparity(img1, img2, win_size=11, max_disp=16, min_disp=0,
                  gamma=10.0, f_max=120.0, iterations=3, consistent=False,
                  cost_method="sd", bins=20, mi_iterations=2,
                  normalize=False, step=1, disp0=None):
    """GSW disparity map (H, W) int16 of one (H, W, 3) BGR tensor pair on
    its device: :func:`gsw_disparity_batch` of a stack of one."""
    if img1.dim() != 3 or img1.shape[2] != 3 or img1.shape != img2.shape:
        raise ValueError(
            "Images must be 3-channel BGR with identical shapes!")
    return gsw_disparity_batch(
        img1[None], img2[None], win_size=win_size, max_disp=max_disp,
        min_disp=min_disp, gamma=gamma, f_max=f_max, iterations=iterations,
        consistent=consistent, cost_method=cost_method, bins=bins,
        mi_iterations=mi_iterations, normalize=normalize, step=step,
        disp0=disp0)[0]


class StereoGSW:
    """Geodesic Support-Weight matcher.

    Same constructor, validation and results as
    :class:`simplestereo_tpu.passive.StereoGSW`, plus ``device``: the
    matcher runs there (``"cuda"``: the hand-written kernel; ``"cpu"``:
    the plain PyTorch twin). A CUDA device without a card raises. There
    is no ``engine`` argument: the device decides.

    ``costMethod``: "sd" (the reference's weighted capped colour
    distance), "mi" (per-pixel mutual information, refined
    ``miIterations`` times from a random bootstrap field) or "auto" (MI
    when the radiometric probe exceeds :data:`MI_AUTO_THRESHOLD`); the
    resolved choice of the last call is ``lastCostMethod``.
    ``compute``/``computeBatch`` take an optional ``disp0``, the (H, W)
    MI bootstrap field (default: drawn from a generator seeded 0).
    """

    def __init__(self, winSize=11, maxDisparity=16, minDisparity=0,
                 gamma=10, fMax=120, iterations=3, bins=20,
                 consistent=False, costMethod="sd", miIterations=2,
                 normalize=False, step=1, device="cuda"):
        if winSize <= 0 or winSize % 2 == 0:
            raise ValueError("winSize must be a positive odd number!")
        if costMethod not in ("sd", "mi", "auto"):
            raise ValueError("costMethod must be 'sd', 'mi' or 'auto'!")
        self.winSize = winSize
        self.maxDisparity = maxDisparity
        self.minDisparity = minDisparity
        self.gamma = gamma
        self.fMax = fMax
        self.iterations = iterations
        self.bins = bins  # joint-histogram bins for costMethod="mi"
        self.consistent = consistent
        self.costMethod = costMethod
        self.miIterations = miIterations
        self.normalize = normalize  # ASW-style weighted-mean cost
        self.step = step  # window-offset lattice stride
        self.device = resolve_device(device)
        self.lastCostMethod = None  # resolved choice of the last compute

    def _run(self, imgs1, imgs2, disp0):
        self.lastCostMethod = resolve_cost_method(imgs1, imgs2,
                                                  self.costMethod,
                                                  step=self.step)
        if disp0 is not None:
            disp0 = torch.tensor(np.asarray(disp0), device=self.device)
        return gsw_disparity_batch(
            torch.tensor(imgs1, device=self.device),
            torch.tensor(imgs2, device=self.device),
            win_size=self.winSize, max_disp=self.maxDisparity,
            min_disp=self.minDisparity, gamma=float(self.gamma),
            f_max=float(self.fMax), iterations=self.iterations,
            consistent=self.consistent, cost_method=self.lastCostMethod,
            bins=self.bins, mi_iterations=self.miIterations,
            normalize=self.normalize, step=self.step,
            disp0=disp0).cpu().numpy()

    def compute(self, img1, img2, disp0=None):
        """(H, W) int16 numpy disparity of an (H, W, 3) BGR numpy pair,
        referred to img1."""
        img1 = np.ascontiguousarray(img1)
        img2 = np.ascontiguousarray(img2)
        if img1.ndim != 3 or img1.shape[2] != 3 or img1.shape != img2.shape:
            raise ValueError(
                "Images must be 3-channel BGR with identical shapes!")
        return self._run(img1[None], img2[None], disp0)[0]

    def computeBatch(self, imgs1, imgs2, disp0=None):
        """Batched :meth:`compute`: (B, H, W, 3) stacks -> (B, H, W), one
        launch set for the stack (both matching directions when
        ``consistent``), bit-identical to per-frame :meth:`compute`. "auto"
        probes the whole batch once (a capture batch shares its
        cameras)."""
        imgs1 = np.ascontiguousarray(imgs1)
        imgs2 = np.ascontiguousarray(imgs2)
        if imgs1.ndim != 4 or imgs1.shape[3] != 3 \
                or imgs1.shape != imgs2.shape:
            raise ValueError(
                "Batches must be (B, H, W, 3) BGR with identical shapes!")
        return self._run(imgs1, imgs2, disp0)
