"""
parallel.sgm
============

Row-tiled SGM over a mesh axis: the port of
:mod:`simplestereo_tpu.parallel.sgm`.

- **Cost volume**: local to each rank after a raw-row halo exchange of
  ``blockSize//2 + max(1, censusWindow//2)`` rows (the BT/census and box
  filter's reach). Raw halo rows beyond the image are edge-filled, and the
  cost rows beyond it too (``row_valid``), so the box filter sees a whole
  frame's edge padding.
- **Horizontal paths**: the scans run along x, so they are local.
- **Vertical and diagonal paths**: a row recurrence that does not
  associate, so they run as a wavefront of n stages: at stage s rank s
  scans its tile downward and rank n-1-s upward, each on the path kernel
  (:func:`..passive.sgm_cuda.aggregate` with ``directions`` and
  ``carry``) from the (k, W, D) row its neighbour handed it; after every
  stage every rank passes its downward carry to rank i + 1 and its upward
  one to rank i - 1 (one ``batch_isend_irecv``).
- **Winner-take-all, uniqueness, subpixel, LR check**: along rows, local.

Each direction's L goes into its buffer of one workspace, and the buffers
are summed in ``_aggregate``'s order (:func:`..passive.sgm_cuda.sum_paths`),
so the map equals the single-card matcher's bit for bit: the carry handed
across a tile boundary is the whole image's scan state at that row.
"""

from ..passive.sgm import _edge_fill_rows, _sgm_cost, _sgm_post
from ..passive.sgm_cuda import aggregate, carry_of, sum_paths
from . import (_axis, _shift, _split, _tensor, all_gather_cat,
               halo_exchange_rows, mesh_device)


def _wavefront(C, P1, P2, paths, L, mesh, axis_name):
    """The downward and upward scans of the vertical and diagonal
    directions across the ranks of the axis, into their buffers of L."""
    n, idx, _ = _axis(mesh, axis_name)
    shape = ((3 if paths >= 8 else 1),) + C.shape[:-3] + C.shape[-2:]
    cd = cu = None
    for s in range(n):
        if idx == s:
            aggregate(C, P1, P2, paths, directions="down", carry=cd, out=L)
            cd = carry_of(L, "down", paths)
        if idx == n - 1 - s:
            aggregate(C, P1, P2, paths, directions="up", carry=cu, out=L)
            cu = carry_of(L, "up", paths)
        if n > 1:
            # Every rank exchanges both carries at every stage; a rank that
            # has not scanned yet passes zeros, which nobody uses.
            if cd is None:
                cd = C.new_zeros(shape)
            if cu is None:
                cu = C.new_zeros(shape)
            cd = _shift(cd, mesh, axis_name, down=True)
            cu = _shift(cu, mesh, axis_name, down=False)
            if idx == 0:
                cd = None
            if idx == n - 1:
                cu = None


def tiled_sgm_disparity(img1, img2, mesh, row_axis="rows", *,
                        min_disp=0, num_disp=16, block_size=3,
                        P1=None, P2=None, paths=8, prefilter_cap=63.0,
                        uniqueness=10.0, disp12_max_diff=-1, subpixel=True,
                        cost_method="bt", census_window=5):
    """Row-tiled SGM disparity over a mesh axis.

    Parameters mirror :class:`simplestereo_tpu_torch.passive.StereoSGM`
    in snake case. Every rank passes the whole (H, W[, 3]) pair and gets
    the whole OpenCV-convention (H, W) int16 disparity x16 back on its
    device, equal to the single-card matcher's.
    """
    if P1 is None:
        P1 = 8 * block_size * block_size
    if P2 is None:
        P2 = 32 * block_size * block_size
    dev = mesh_device(mesh)
    i1, i2 = _tensor(img1, dev), _tensor(img2, dev)
    n, idx, _ = _axis(mesh, row_axis)
    hl = _split(n, i1.shape[0], row_axis, "image rows")
    pre = max(1, census_window // 2 if "census" in cost_method else 1)
    halo = block_size // 2 + pre
    e1, valid = halo_exchange_rows(i1[idx * hl:(idx + 1) * hl], halo, mesh,
                                   row_axis)
    e2, _ = halo_exchange_rows(i2[idx * hl:(idx + 1) * hl], halo, mesh,
                               row_axis)
    C = _sgm_cost(_edge_fill_rows(e1, valid), _edge_fill_rows(e2, valid),
                  min_disp=min_disp, num_disp=num_disp,
                  block_size=block_size, prefilter_cap=prefilter_cap,
                  cost_method=cost_method, census_window=census_window,
                  row_valid=valid)[halo:-halo].contiguous()
    P1, P2 = float(P1), float(P2)
    L = aggregate(C, P1, P2, paths, directions="horizontal")
    _wavefront(C, P1, P2, paths, L, mesh, row_axis)
    del C
    d = _sgm_post(sum_paths(L), min_disp=min_disp, num_disp=num_disp,
                  uniqueness=uniqueness, disp12_max_diff=disp12_max_diff,
                  subpixel=subpixel)
    return all_gather_cat(d, mesh, row_axis)


__all__ = ["tiled_sgm_disparity"]
