"""
parallel.gsw
============

Row-tiled GSW matcher over a mesh axis: the port of
:mod:`simplestereo_tpu.parallel.gsw`. The support weights have a closed
form, so every stage is elementwise or a window-local sum, and row tiling
needs only a ``winSize//2`` halo exchange; the LR check and occlusion fill
work along rows and stay local.

Halo rows beyond the image are filled with a large finite sentinel (1e9)
in both images: their colour distance to any real pixel takes the weight
``exp(-d/gamma)`` to exactly 0 (on the kernel's approximate ``exp2`` too),
so an off-image window pixel adds exactly 0, as the whole image's padding
does; a finite value keeps ``min(fMax, dist)`` free of NaN where both
operands are sentinels. The map equals the single-card matcher's.
"""

import torch

from ..passive.gsw import gsw_disparity
from . import (_axis, _split, _tensor, all_gather_cat, halo_exchange_rows,
               mesh_device)

_SENTINEL = 1e9  # exp(-1e9/gamma) == 0.0 in float32 for any sane gamma


def tiled_gsw_disparity(img1, img2, mesh, row_axis="rows", *,
                        win_size=11, max_disp=16, min_disp=0, gamma=10.0,
                        f_max=120.0, iterations=1, consistent=False,
                        normalize=False, step=1):
    """Row-tiled GSW disparity ("sd" cost) over a mesh axis.

    Parameters as :func:`simplestereo_tpu_torch.passive.gsw.gsw_disparity`
    (the JAX function's ``engine`` and ``interpret`` are left out: the
    mesh's device decides). Every rank passes the whole (H, W, 3) pair and
    gets the whole (H, W) int16 map back on its device.
    """
    dev = mesh_device(mesh)
    i1, i2 = _tensor(img1, dev), _tensor(img2, dev)
    n, idx, _ = _axis(mesh, row_axis)
    hl = _split(n, i1.shape[0], row_axis, "image rows")
    halo = win_size // 2
    rows = slice(idx * hl, (idx + 1) * hl)
    e1, valid = halo_exchange_rows(i1[rows].to(torch.float32), halo, mesh,
                                   row_axis)
    e2, _ = halo_exchange_rows(i2[rows].to(torch.float32), halo, mesh,
                               row_axis)
    keep = valid[:, None, None]
    d = gsw_disparity(torch.where(keep, e1, _SENTINEL),
                      torch.where(keep, e2, _SENTINEL), win_size=win_size,
                      max_disp=max_disp, min_disp=min_disp, gamma=gamma,
                      f_max=f_max, iterations=iterations,
                      consistent=consistent, normalize=normalize, step=step)
    return all_gather_cat(d[halo:hl + halo], mesh, row_axis)


__all__ = ["tiled_gsw_disparity"]
