"""
parallel
========

Multi-card scaling of the dense stereo pipelines on ``torch.distributed``:
the port of :mod:`simplestereo_tpu.parallel`.

One process a card, as ``torchrun --nproc-per-node`` starts them; NCCL
between CUDA ranks, gloo between CPU ranks. A mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` with named axes
(:func:`make_mesh`), PyTorch's form of ``jax.sharding.Mesh``. The JAX
package's ``shard_map`` bodies become plain functions that every rank of
the mesh calls with the same whole-image inputs (as each JAX process does
in its multi-process mode): a rank takes its own rows or frames, exchanges
what its neighbours need, runs the single-card matcher on its block and
gets the whole result back through an ``all_gather``. The collectives map
one to one: ``ppermute`` -> ``batch_isend_irecv`` on the axis's group,
``psum`` -> ``all_reduce`` SUM, ``pmin``/``pmax`` -> MIN/MAX,
``all_gather`` -> ``all_gather``. Every rank of a group makes every
exchange; no collective sits in a branch that depends on the rank.

- **frame-batch data parallelism**: a batch over a mesh axis
  (:func:`batch_parallel`, :func:`tiled_asw_disparity_batch`);
- **spatial row tiling**: rows over a mesh axis with a ``winSize//2`` halo
  exchanged between neighbours (:func:`halo_exchange_rows`); halo rows
  received at the image's true boundary are marked invalid
  (``row_valid``), so the result equals the single-card matcher's;
- **collective reductions**: :func:`psum_stats`, and the Gauss-Newton
  normal equations of :mod:`..calibration.sharded`.

A CUDA mesh needs a card and NCCL and raises without them; a CPU mesh is
asked for with ``device_type="cpu"``. Nothing falls back from one to the
other.
"""

import os
import socket

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _check_device_type(device_type):
    if device_type not in _BACKENDS:
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh needs a card, and "
                               "torch.cuda.is_available() is False")
        if not dist.is_nccl_available():
            raise RuntimeError("a CUDA mesh needs NCCL, and this PyTorch "
                               "has none")


def free_port():
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(device_type="cuda", *, world_size=None, rank=None,
                     init_method=None):
    """Join this process to the default process group: NCCL for
    ``device_type="cuda"``, gloo for ``"cpu"``.

    Under ``torchrun`` (``WORLD_SIZE`` in the environment) the group comes
    from the environment and ``LOCAL_RANK`` names the card. Otherwise pass
    ``world_size`` and ``rank``, and ``init_method`` (``tcp://host:port``)
    unless the world is one process, which gets a free port on localhost:
    that is how a script started with plain ``python`` runs as a world of
    one. A CUDA rank is put on ``cuda:{LOCAL_RANK}`` (``cuda:{rank}``
    without torchrun). Returns ``(rank, world_size)``; a process already
    in a group of the right backend keeps it.
    """
    _check_device_type(device_type)
    backend = _BACKENDS[device_type]
    if dist.is_initialized():
        if backend not in dist.get_backend():
            raise RuntimeError(f"the process group runs "
                               f"{dist.get_backend()}, a {device_type} "
                               f"mesh needs {backend}")
        return dist.get_rank(), dist.get_world_size()
    if world_size is None:
        if "WORLD_SIZE" not in os.environ:
            raise RuntimeError("not started by torchrun: pass world_size "
                               "and rank (world_size=1, rank=0 for one "
                               "process)")
        world_size = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
        init_method = init_method or "env://"
    elif rank is None:
        raise ValueError("world_size needs a rank")
    if init_method is None:
        if world_size != 1:
            raise ValueError("a world of several processes needs an "
                             "init_method (tcp://host:port)")
        init_method = f"tcp://localhost:{free_port()}"
    kw = {}
    if device_type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        torch.cuda.set_device(local)
        kw["device_id"] = torch.device("cuda", local)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)
    return rank, world_size


def make_mesh(axis_sizes, devices=None, *, device_type="cuda"):
    """A :class:`~torch.distributed.device_mesh.DeviceMesh` with named axes.

    Parameters
    ----------
    axis_sizes : dict
        e.g. ``{"batch": 2, "rows": 4}``; the product must equal the number
        of ranks.
    devices : optional increasing sequence of global ranks (default: every
        rank of the default process group). Every rank of the group must
        call this, those outside ``devices`` too.
    device_type : ``"cuda"`` (NCCL; each rank's card, see
        :func:`init_distributed`) or ``"cpu"`` (gloo).

    Raises RuntimeError for a CUDA mesh without a card or NCCL, or without
    a process group of the matching backend (:func:`init_distributed`
    makes one), and ValueError when the sizes do not match the ranks.
    """
    from torch.distributed.device_mesh import DeviceMesh

    _check_device_type(device_type)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel."
                           "init_distributed first (or start under torchrun)")
    backend = _BACKENDS[device_type]
    if backend not in dist.get_backend():
        raise RuntimeError(f"the process group runs {dist.get_backend()}, "
                           f"a {device_type} mesh needs {backend}")
    if devices is None:
        devices = range(dist.get_world_size())
    devices = [int(r) for r in devices]
    if devices != sorted(set(devices)):
        raise ValueError(f"devices must be increasing ranks, got {devices}")
    names = tuple(axis_sizes)
    shape = tuple(int(axis_sizes[n]) for n in names)
    if int(np.prod(shape)) != len(devices):
        raise ValueError(
            f"mesh {axis_sizes} needs {int(np.prod(shape))} ranks, got "
            f"{len(devices)}")
    return DeviceMesh(device_type, torch.tensor(devices).reshape(shape),
                      mesh_dim_names=names)


def mesh_device(mesh):
    """The device of this rank's tensors on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _axis(mesh, name):
    """(size, this rank's index, process group) of mesh axis ``name``."""
    if mesh.get_coordinate() is None:
        raise ValueError(f"rank {dist.get_rank()} is not on the mesh")
    if name not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"the mesh has no axis {name!r}: its axes are "
                         f"{mesh.mesh_dim_names}")
    return (mesh.shape[mesh.mesh_dim_names.index(name)],
            mesh.get_local_rank(name), mesh.get_group(name))


def _tensor(x, dev):
    """``x`` (array or tensor) as a tensor on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    return torch.as_tensor(np.ascontiguousarray(x), device=dev)


def _split(n, size, name, what):
    if size % n:
        raise ValueError(f"{what} {size} not divisible by mesh axis "
                         f"{name}={n}")
    return size // n


def _shift(x, mesh, axis_name, down):
    """``x`` of the previous rank along the axis (``down``: i receives from
    i - 1; else from i + 1), zeros at the end that has none: ``ppermute``
    over a chain."""
    n, idx, group = _axis(mesh, axis_name)
    out = x.new_zeros(x.shape)
    if n == 1:
        return out
    src, dst = (idx - 1, idx + 1) if down else (idx + 1, idx - 1)
    ops = []
    x = x.contiguous()
    if 0 <= dst < n:
        ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, dst),
                              group))
    if 0 <= src < n:
        ops.append(dist.P2POp(dist.irecv, out,
                              dist.get_global_rank(group, src), group))
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out


def all_gather_cat(x, mesh, axis_name, dim=0):
    """This rank's block ``x`` and those of the other ranks of the axis,
    concatenated along ``dim`` in the axis's order (``all_gather``). The
    blocks travel as bytes: neither NCCL nor gloo has int16 or bool."""
    _, _, group = _axis(mesh, axis_name)
    b = x.contiguous().view(torch.uint8)
    parts = [torch.empty_like(b) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, b, group=group)
    return torch.cat(parts, dim=dim % x.dim()).view(x.dtype)


def all_reduce(x, mesh, axis_names, op="sum"):
    """``psum``/``pmin``/``pmax`` of ``x`` over the named axes (in place;
    returns ``x``)."""
    red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
           "max": dist.ReduceOp.MAX}[op]
    for name in ((axis_names,) if isinstance(axis_names, str)
                 else axis_names):
        dist.all_reduce(x, op=red, group=_axis(mesh, name)[2])
    return x


def halo_exchange_rows(x, halo, mesh, axis_name="rows", row_axis=0):
    """Extend a row block with ``halo`` rows from each neighbour.

    x : this rank's block, its ``row_axis`` dimension the image rows of the
    rank (e.g. (H_local, W, 3) with ``row_axis=0``, or a frame stack
    (B, H_local, W, 3) with ``row_axis=1``).

    Returns (x extended by 2 * halo rows along ``row_axis``,
    (H_local + 2 * halo,) bool ``row_valid``): the first and last ranks
    have no neighbour on one side; those halo rows are zeros and marked
    invalid, so that the matchers treat them as out-of-image rows. Rank i
    sends its last ``halo`` rows to rank i + 1 and its first ones to rank
    i - 1 (a ``batch_isend_irecv`` each way). Raises ValueError when the
    halo is taller than a block (the neighbour does not have the rows).
    """
    n, idx, _ = _axis(mesh, axis_name)
    hl = x.shape[row_axis]
    if n > 1 and halo > hl:
        raise ValueError(f"halo of {halo} rows is taller than a tile: "
                         f"H / n = {hl} rows")
    if n == 1 or not halo:  # the image's boundary on both sides, or none
        shape = list(x.shape)
        shape[row_axis] = halo
        from_prev = from_next = x.new_zeros(shape)
    else:
        from_prev = _shift(x.narrow(row_axis, hl - halo, halo), mesh,
                           axis_name, down=True)
        from_next = _shift(x.narrow(row_axis, 0, halo), mesh, axis_name,
                           down=False)
    x = torch.cat([from_prev, x, from_next], dim=row_axis)
    valid = torch.ones(hl + 2 * halo, dtype=torch.bool, device=x.device)
    valid[:halo] = idx > 0
    valid[hl + halo:] = idx < n - 1
    return x, valid


def tiled_asw_disparity(img1, img2, mesh, row_axis="rows", win_size=35,
                        max_disp=16, min_disp=0, gamma_c=5.0, gamma_p=17.5,
                        consistent=False):
    """Row-tiled ASW disparity over a mesh axis.

    Every rank passes the whole (H, W, 3) pair and gets the whole (H, W)
    int16 map back on its device. A rank takes its H / n rows, exchanges
    ``win_size // 2`` halo rows with its neighbours and runs the ASW kernel
    in context mode: the halo rows feed the boundary windows as sources
    only. The LR check and occlusion fill work along rows, so they stay
    local. The map equals the single-card matcher's.
    """
    from ..passive.asw_cuda import asw_disparity

    dev = mesh_device(mesh)
    i1, i2 = _tensor(img1, dev), _tensor(img2, dev)
    n, idx, _ = _axis(mesh, row_axis)
    hl = _split(n, i1.shape[0], row_axis, "image rows")
    halo = win_size // 2
    e1, valid = halo_exchange_rows(i1[idx * hl:(idx + 1) * hl], halo, mesh,
                                   row_axis)
    e2, _ = halo_exchange_rows(i2[idx * hl:(idx + 1) * hl], halo, mesh,
                               row_axis)
    d = asw_disparity(e1, e2, win_size=win_size, max_disp=max_disp,
                      min_disp=min_disp, gamma_c=gamma_c, gamma_p=gamma_p,
                      consistent=consistent, row_valid=valid,
                      context=halo > 0)
    return all_gather_cat(d, mesh, row_axis)


def tiled_asw_disparity_batch(imgs1, imgs2, mesh, row_axis="rows",
                              batch_axis="batch", win_size=35, max_disp=16,
                              min_disp=0, gamma_c=5.0, gamma_p=17.5,
                              consistent=False):
    """Frame-batch data parallelism x row tiling over a 2-D mesh.

    (B, H, W, 3) stacks: a rank takes B / n_batch frames and H / n_rows
    rows of them, exchanges halo rows with its row neighbours and runs one
    kernel launch for its frames. Returns the whole (B, H, W) int16 stack
    on every rank, equal to per-frame single-card maps.
    """
    from ..passive.asw_cuda import asw_disparity_batch

    dev = mesh_device(mesh)
    i1, i2 = _tensor(imgs1, dev), _tensor(imgs2, dev)
    n_rows, ir, _ = _axis(mesh, row_axis)
    n_batch, ib, _ = _axis(mesh, batch_axis)
    hl = _split(n_rows, i1.shape[1], row_axis, "image rows")
    bl = _split(n_batch, i1.shape[0], batch_axis, "batch")
    halo = win_size // 2

    def block(a):
        return a[ib * bl:(ib + 1) * bl, ir * hl:(ir + 1) * hl]

    e1, valid = halo_exchange_rows(block(i1), halo, mesh, row_axis, 1)
    e2, _ = halo_exchange_rows(block(i2), halo, mesh, row_axis, 1)
    d = asw_disparity_batch(
        e1, e2, win_size=win_size, max_disp=max_disp, min_disp=min_disp,
        gamma_c=gamma_c, gamma_p=gamma_p, consistent=consistent,
        row_valid=valid.expand(bl, -1), context=halo > 0)
    return all_gather_cat(all_gather_cat(d, mesh, row_axis, 1), mesh,
                          batch_axis, 0)


def batch_parallel(fn, mesh, batch_axis="batch"):
    """Data-parallel map of a per-example ``fn`` over a batch axis.

    ``fn`` maps unbatched pytrees of tensors to unbatched pytrees; the
    returned callable takes arguments with a leading batch dimension (the
    whole batch, the same on every rank), applies ``fn`` to this rank's
    B / n examples one by one, and returns the whole batch of results
    (``all_gather`` over the axis) on the mesh's device.
    """
    def run(*args):
        dev = mesh_device(mesh)
        n, idx, _ = _axis(mesh, batch_axis)
        args = pytree.tree_map(lambda a: _tensor(a, dev), args)
        B = pytree.tree_leaves(args)[0].shape[0]
        bl = _split(n, B, batch_axis, "batch")
        outs = [fn(*pytree.tree_map(lambda a: a[i], args))
                for i in range(idx * bl, (idx + 1) * bl)]
        local = pytree.tree_map(lambda *xs: torch.stack(xs), *outs)
        return pytree.tree_map(
            lambda x: all_gather_cat(x, mesh, batch_axis), local)

    return run


def psum_stats(x, mesh, axis_names):
    """Global (sum, count) of ``x`` whose dimension i is split over mesh
    axis ``axis_names[i]``: each rank sums its block, then ``all_reduce``
    SUM over the axes. Returns a float32 tensor [sum, count]."""
    dev = mesh_device(mesh)
    xl = _tensor(x, dev)
    for dim, name in enumerate(axis_names):
        n, idx, _ = _axis(mesh, name)
        size = _split(n, xl.shape[dim], name, f"dimension {dim}")
        xl = xl.narrow(dim, idx * size, size)
    out = torch.stack([xl.sum().to(torch.float32),
                       torch.tensor(float(xl.numel()), device=dev)])
    return all_reduce(out, mesh, axis_names)


from .sgm import tiled_sgm_disparity          # noqa: E402
from .gsw import tiled_gsw_disparity          # noqa: E402
from .ftp import sharded_ftp_cloud            # noqa: E402

__all__ = [
    "make_mesh",
    "halo_exchange_rows",
    "tiled_asw_disparity",
    "tiled_asw_disparity_batch",
    "tiled_sgm_disparity",
    "tiled_gsw_disparity",
    "sharded_ftp_cloud",
    "batch_parallel",
    "psum_stats",
]
