"""
parallel.ftp
============

Row-sharded StereoFTP point cloud over a mesh axis: the port of
:mod:`simplestereo_tpu.parallel.ftp`. Every dense stage of the fused FTP
pipeline works per row or per pixel, so a rank computes its own band of
the ROI's rows:

- **grayscale, projector mapping, virtual reference**: per pixel, for the
  band's global rows (the anaglyph ``B - R`` normalisation needs the
  global min and max: ``all_reduce`` MIN and MAX);
- **row-FFT band-pass phase**: the FFT runs along x, local;
- **2-D unwrap**: along x per row; along y a prefix sum down the columns
  of corrections that each depend on one step's difference alone, so it
  is a local cumulative sum plus the totals of the ranks above: one
  exchange of the boundary row and one ``all_gather`` of the ranks'
  column totals. The corrections are summed in float64, as the
  single-card unwrap sums them, so every partial sum is exact and the
  phase equals the single-card one;
- **fringe order k**: a mean over the stripe's pixels, as sums over each
  rank's stripe rows and ``all_reduce`` SUM;
- **dense triangulation**: per pixel, with the band's first row.

The cloud's rows are gathered at the end (``all_gather``), so every rank
returns the whole cloud, as the JAX function's multi-process form does.
"""

import math

import numpy as np
import torch

from ..active.ftp import (StereoFTP_Mapping, StereoFTP_PhaseOnly,
                          _dense_cloud, _f32, _phase_pipeline)
from ..geometry._small import apply_affine
from ..geometry.distortion import distort_normalized
from .. import unwrapping, warp
from . import (_axis, _shift, _split, all_gather_cat, all_reduce,
               mesh_device)


def _projector_mapping_rows(z, M, T, K2, dist2, fringe_gray, xs, row0,
                            n_rows, row_inv):
    """Row band of :func:`..active.ftp._projector_mapping` for one depth
    ``z``: projector coordinates (n_rows, w, 2) and virtual reference
    (n_rows, w) of image rows ``[row0, row0 + n_rows)`` and columns
    ``xs``; pointwise the same operations as the whole grid's."""
    ys = row0 + torch.arange(n_rows, dtype=torch.float32, device=z.device)
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")

    def project(gx, gy):
        q = [z * m + T[i] for i, m in enumerate(apply_affine(M, [gx, gy]))]
        xyd = distort_normalized(torch.stack([q[0] / q[2], q[1] / q[2]], -1),
                                 dist2)
        u = K2[0, 0] * xyd[..., 0] + K2[0, 1] * xyd[..., 1] + K2[0, 2]
        v = K2[1, 1] * xyd[..., 1] + K2[1, 2]
        return u, v

    uc, vc = project(gx + 0.5, gy + 0.5)
    ui, vi = project(gx, gy)
    remap = warp.remap_row_invariant if row_inv else warp.remap
    return (torch.stack([uc, vc], dim=-1),
            remap(fringe_gray, ui, vi, interpolation="cubic"))


def _unwrap_rows_sharded(p, mesh, axis_name):
    """``unwrapping.unwrap(p, axis=0)`` of a row-sharded (H_local, W)
    block: the corrections of each step (rank i's first step uses rank
    i - 1's last row) summed down the columns in float64, offset by the
    column totals of the ranks above."""
    n, idx, _ = _axis(mesh, axis_name)
    prev_last = _shift(p[-1], mesh, axis_name, down=True)
    dd = torch.diff(torch.cat([prev_last[None], p]), dim=0)
    period = unwrapping._const(2 * math.pi, p)
    interval = period / 2
    ddmod = unwrapping._floor_mod(dd + interval, period) - interval
    ddmod = torch.where((ddmod == -interval) & (dd > 0), interval, ddmod)
    corr = torch.where(dd.abs() < interval, torch.zeros_like(dd),
                       ddmod - dd)
    if idx == 0:
        corr[0] = 0.0  # the image's first row has no predecessor
    cs = torch.cumsum(corr.to(torch.float64), dim=0)
    totals = all_gather_cat(cs[-1:], mesh, axis_name)     # (n, W)
    return p + (cs + totals[:idx].sum(dim=0)).to(p.dtype)


def sharded_ftp_cloud(ftp, imgObj, mesh, row_axis="rows", *,
                      radius_factor=0.5, roi=None):
    """Row-sharded :meth:`StereoFTP.getCloud` over a mesh axis.

    Every rank passes the same capture; the host preamble (undistortion,
    stripe and carrier estimation, ``StereoFTP._cloud_prep``) runs on each
    rank as on one card, then each rank runs the fused pipeline on its
    band of the ROI's rows. Works for :class:`StereoFTP` and
    :class:`StereoFTPAnaglyph` (gray modes "max", "br" and pre-converted
    "host" frames); the scanner's device must be the mesh's. Returns the
    (roi_h, roi_w, 3) float64 cloud on every rank.
    """
    if isinstance(ftp, StereoFTP_PhaseOnly):
        raise TypeError("StereoFTP_PhaseOnly has no cloud output; "
                        "shard getPhase via parallel.batch_parallel")
    if isinstance(ftp, StereoFTP_Mapping):
        raise TypeError("StereoFTP_Mapping uses the classic no-virtual-"
                        "reference pipeline; only the fused StereoFTP/"
                        "StereoFTPAnaglyph path is row-sharded")
    dev = mesh_device(mesh)
    if ftp.device.type != dev.type:
        raise ValueError(f"the scanner runs on {ftp.device}, the mesh on "
                         f"{dev}")
    prep = ftp._cloud_prep(imgObj, radius_factor, roi)
    roi_x, roi_y, roi_w, roi_h = (int(v) for v in prep["roi"])
    n, idx, _ = _axis(mesh, row_axis)
    hl = _split(n, roi_h, row_axis, "ROI rows")
    rows = slice(idx * hl, (idx + 1) * hl)
    t = ftp._rig_tensors()
    img_l = prep["imgObj"][rows].to(dev)
    row0 = torch.tensor(float(roi_y + idx * hl), dtype=torch.float32,
                        device=dev)

    gray_mode = prep["gray_mode"]
    if gray_mode == "br":  # anaglyph: globally normalised B - R
        d = (img_l[..., 0].to(torch.float32)
             - img_l[..., 2].to(torch.float32))
        lo = all_reduce(d.amin().reshape(1), mesh, row_axis, "min")
        hi = all_reduce(d.amax().reshape(1), mesh, row_axis, "max")
        ptp = hi - lo
        gray = (d - lo) / torch.where(ptp > 0, ptp, torch.ones_like(ptp))
    elif gray_mode == "host":  # already a 2-D frame
        gray = img_l.to(torch.float32)
    else:  # "max": per-pixel channel max
        gray = img_l.amax(dim=-1).to(torch.float32)

    z = torch.tensor(prep["z_plane"], dtype=torch.float32, device=dev)
    pc_l, vref_l = _projector_mapping_rows(
        z, t["M"], t["T"], t["K2"], t["dist2"], t["fringe_gray"],
        torch.arange(roi_x, roi_x + roi_w, dtype=torch.float32, device=dev),
        row0, hl, ftp._fringe_row_inv)
    fc, radius = prep["fc"], prep["radius"]
    phase = _phase_pipeline(gray, vref_l, _f32(fc - radius, dev)[rows],
                            _f32(fc + radius, dev)[rows])
    pu = _unwrap_rows_sharded(unwrapping.unwrap(phase, axis=-1), mesh,
                              row_axis)

    # Fringe order k: the mean over the stripe's pixels, summed over the
    # ranks. The stripe indices are (column, row) in ROI coordinates, with
    # jnp's gather rules (a negative index counts from the end, then
    # clamps), as the single-card path reads them.
    sidx = torch.as_tensor(np.asarray(prep["stripe_idx"]), device=dev)
    sy = torch.where(sidx[:, 1] < 0, sidx[:, 1] + roi_h,
                     sidx[:, 1]).clamp(0, roi_h - 1) - idx * hl
    sx = torch.where(sidx[:, 0] < 0, sidx[:, 0] + roi_w,
                     sidx[:, 0]).clamp(0, roi_w - 1)
    mine = (sy >= 0) & (sy < hl)
    syc = sy.clamp(0, hl - 1)
    two_pi = torch.tensor(2 * math.pi, dtype=torch.float32, device=dev)
    kv = (t["peak"] - pc_l[syc, sx, 0]) * t["fp"] - pu[syc, sx] / two_pi
    sums = torch.stack([torch.where(mine, kv, 0.0).sum(),
                        mine.to(torch.float32).sum()])
    all_reduce(sums, mesh, row_axis)
    k = torch.ceil(sums[0] / sums[1] - 0.5)

    cloud = _dense_cloud(pc_l[None], pu[None], k.reshape(1), t["ep"],
                         t["fp"], t["K2"], t["dist2"], t["Rect1"],
                         t["Rect2"], t["R_inv3"], t["baseline"], roi_x,
                         row0)[0]
    return all_gather_cat(cloud, mesh, row_axis).cpu().numpy().astype(
        np.float64)


__all__ = ["sharded_ftp_cloud"]
