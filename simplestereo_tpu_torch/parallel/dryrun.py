"""
parallel.dryrun
===============

Whole-mesh checks of :mod:`simplestereo_tpu_torch.parallel`, as functions
that ``torchrun`` or a test can call, and :func:`spawn`, which starts a
world of gloo processes on this host and runs jobs in it.

- :func:`dryrun_multichip` is the port of the JAX package's
  ``__graft_entry__.dryrun_multichip``: one step of frame-batch data
  parallelism x row tiling with a halo exchange and an ``all_reduce`` mean
  on tiny shapes, then the tiled SGM and GSW matchers, the mesh
  Gauss-Newton calibration and the sharded FTP cloud.
- ``run_asw``, ``run_sgm``, ``run_gsw``, ``run_ftp`` and ``run_ba``
  (:data:`PATHS`) are the per-path workers of the JAX package's
  ``benchmarks/multihost_worker.py``: each runs one collective path on a
  ``{"rows": n}`` mesh and checks it against the single-card function.

Run under torchrun (one process a card; ``--device cpu`` for gloo
processes):

    torchrun --nproc-per-node N -m simplestereo_tpu_torch.parallel.dryrun \\
        [--device cuda|cpu] [dryrun|asw|sgm|gsw|ftp|ba ...]

Rank 0 prints one ``MULTIHOST-OK path=<p> ...`` line a path. A spawned
process imports ``torch`` and this package only, never JAX.
"""

import importlib
import multiprocessing
import os
import queue
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from . import (init_distributed, free_port, make_mesh, mesh_device,
               all_reduce, all_gather_cat, halo_exchange_rows)


# -- the per-path workers ---------------------------------------------------

def _frame_pair(n):
    """The same frame on every rank (same seed): 4 rows a rank, 40 wide."""
    rng = np.random.default_rng(0)
    img1 = rng.integers(0, 256, (4 * n, 40, 3), np.uint8)
    return img1, np.roll(img1, -2, axis=1)


def _size(mesh):
    return mesh.shape[mesh.mesh_dim_names.index("rows")]


def run_asw(mesh, consistent=False):
    """Row-tiled ASW (halo exchange) and the ``psum_stats`` reduction,
    checked against the single-card matcher (bit-equal)."""
    from . import psum_stats, tiled_asw_disparity
    from ..passive.asw_cuda import asw_disparity

    n, dev = _size(mesh), mesh_device(mesh)
    img1, img2 = _frame_pair(n)
    kw = dict(win_size=5, max_disp=4, consistent=consistent)
    tiled = tiled_asw_disparity(img1, img2, mesh, **kw)
    s, c = psum_stats(np.ones((n, 2), np.float32), mesh, ("rows",)).tolist()
    assert s == 2 * n and c == 2 * n, (s, c)
    single = asw_disparity(torch.as_tensor(img1, device=dev),
                           torch.as_tensor(img2, device=dev), **kw)
    assert torch.equal(single, tiled), "tiled ASW differs from one card"
    return "asw=bit-exact"


def run_sgm(mesh, consistent=False):
    """Row-tiled SGM: the wavefront's carries cross every rank boundary."""
    from . import tiled_sgm_disparity
    from ..passive.sgm import _sgm_disparity

    dev = mesh_device(mesh)
    img1, img2 = _frame_pair(_size(mesh))
    tiled = tiled_sgm_disparity(img1, img2, mesh, num_disp=4)
    single = _sgm_disparity(
        torch.as_tensor(img1, device=dev), torch.as_tensor(img2, device=dev),
        min_disp=0, num_disp=4, block_size=3, P1=72.0, P2=288.0, paths=8,
        prefilter_cap=63.0, uniqueness=10.0, disp12_max_diff=-1,
        subpixel=True)
    assert torch.equal(single, tiled), "tiled SGM differs from one card"
    return "sgm=bit-exact"


def run_gsw(mesh, consistent=False):
    """Row-tiled GSW with sentinel halo rows."""
    from . import tiled_gsw_disparity
    from ..passive.gsw import gsw_disparity

    dev = mesh_device(mesh)
    img1, img2 = _frame_pair(_size(mesh))
    kw = dict(win_size=5, max_disp=4, gamma=10.0, f_max=60.0,
              consistent=consistent)
    tiled = tiled_gsw_disparity(img1, img2, mesh, **kw)
    single = gsw_disparity(torch.as_tensor(img1, device=dev),
                           torch.as_tensor(img2, device=dev), iterations=1,
                           **kw)
    assert torch.equal(single, tiled), "tiled GSW differs from one card"
    return "gsw=bit-exact"


def ftp_scene(device, anaglyph=False):
    """The FTP scene of the JAX package's multi-host worker: a 128x96
    camera-projector pair, a plane at z0 = 520 with the fringe (period
    16) rendered on it. Returns (scanner, capture, z0)."""
    from .. import StereoRig, warp
    from ..active import (StereoFTP, StereoFTPAnaglyph, buildAnaglyphFringe,
                          buildFringe)
    from ..geometry.npgeom import rodrigues_to_matrix

    cam = (128, 96)
    K = np.array([[140.0, 0, 63.5], [0, 140.0, 47.5], [0, 0, 1]])
    R = rodrigues_to_matrix(np.array([0.0, -0.05, 0.0]))
    T = np.array([[-40.0], [1.0], [6.0]])
    rig = StereoRig(cam, cam, K, K, None, None, R, T, device=device)
    period, z0 = 16.0, 520.0
    fringe = (buildAnaglyphFringe(period, dims=cam) if anaglyph
              else buildFringe(period, dims=cam, stripeColor="red"))
    gx, gy = np.meshgrid(np.arange(cam[0], dtype=float),
                         np.arange(cam[1], dtype=float))
    rays = np.stack([gx, gy, np.ones_like(gx)], -1) @ np.linalg.inv(K).T
    q = (z0 * rays @ R.T + T.ravel()) @ K.T
    f32 = dict(dtype=torch.float32, device=device)
    img = warp.remap(torch.as_tensor(fringe, device=device),
                     torch.as_tensor(q[..., 0] / q[..., 2], **f32),
                     torch.as_tensor(q[..., 1] / q[..., 2], **f32),
                     interpolation="linear").cpu().numpy()
    ftp = (StereoFTPAnaglyph(rig, fringe, period, stripeColor="green",
                             device=device) if anaglyph
           else StereoFTP(rig, fringe, period, device=device))
    return ftp, img, z0


def run_ftp(mesh, consistent=False):
    """Row-sharded FTP: the y-unwrap's boundary-row exchange and gathered
    column totals, and the summed fringe order."""
    from . import sharded_ftp_cloud

    ftp, img, _ = ftp_scene(mesh_device(mesh))
    sharded = sharded_ftp_cloud(ftp, img, mesh)
    single = ftp.getCloud(img)
    both = np.isfinite(single[..., 2]) & np.isfinite(sharded[..., 2])
    assert both.mean() > 0.9, both.mean()
    dz = float(np.abs(single[..., 2] - sharded[..., 2])[both].max())
    assert dz < 1e-2, f"sharded FTP dz {dz}"
    return f"ftp_dz={dz:.2e}"


def run_ba(mesh, consistent=False):
    """Mesh Gauss-Newton calibration: the views split over the ranks, S
    and g summed over them."""
    from ..calibration import ba
    from ..calibration.sharded import calibrate_camera_sharded

    n = _size(mesh)
    rng = np.random.default_rng(1)
    xx, yy = np.meshgrid(np.arange(7), np.arange(6))
    obj = np.stack([xx.ravel() * 30.0, yy.ravel() * 30.0, np.zeros(42)], 1)
    Kt = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1]])
    V = n * -(-4 // n)  # at least 4 views, a multiple of the ranks
    views = []
    for _ in range(V):
        rvec = rng.normal(0, 0.2, 3)
        tvec = np.array([rng.normal(-90, 20), rng.normal(-75, 20),
                         rng.normal(600, 50)])
        pts = ba.project_points(obj, rvec, tvec, Kt[0, 0], Kt[1, 1],
                                Kt[0, 2], Kt[1, 2], np.zeros(5))
        views.append(pts + rng.normal(0, 0.05, pts.shape))
    Hs = [ba._homography_dlt(obj[:, :2], v) for v in views[:4]]
    fx, fy, cx, cy = ba._zhang_intrinsics(Hs, (640, 480))
    K0 = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    rms, Ke, _, poses = calibrate_camera_sharded(
        np.tile(obj[None], (V, 1, 1)), np.stack(views), K0, np.zeros(5),
        mesh, axis="rows", iterations=15)
    assert rms < 0.2, rms
    assert np.abs(Ke - Kt).max() < 5.0, Ke
    assert poses.shape == (V, 6)
    return f"ba_rms={rms:.4f}"


PATHS = {"asw": run_asw, "sgm": run_sgm, "gsw": run_gsw, "ftp": run_ftp,
         "ba": run_ba}


# -- dryrun_multichip -----------------------------------------------------

def dryrun_multichip(n_devices, device_type="cuda"):
    """One full sharded pipeline step on a mesh of the world's n ranks
    (tiny shapes); the port of ``__graft_entry__.dryrun_multichip``.

    The mesh is rows (spatial tiling with a halo exchange) x batch (frame
    data parallelism; rows take the largest factor <= 4). The step runs
    the batched ASW kernel with ``row_valid`` on each rank's block and an
    ``all_reduce`` over both axes for the mean disparity (the reduction
    pattern of the Gauss-Newton calibration); then tiled SGM, tiled GSW,
    the mesh Gauss-Newton and, where 96 rows divide, the sharded FTP.
    Returns a dict of what each step produced.
    """
    from . import (sharded_ftp_cloud, tiled_gsw_disparity,
                   tiled_sgm_disparity)
    from ..calibration import ba
    from ..calibration.sharded import calibrate_camera_sharded
    from ..passive.asw_cuda import asw_disparity_batch

    if n_devices != dist.get_world_size():
        raise ValueError(f"dryrun_multichip({n_devices}) needs a world of "
                         f"{n_devices} ranks, this one has "
                         f"{dist.get_world_size()}")
    rows = next((r for r in (4, 2) if n_devices % r == 0), 1)
    batch = n_devices // rows
    mesh = make_mesh({"rows": rows, "batch": batch},
                     device_type=device_type)
    dev = mesh_device(mesh)
    WIN, MAXD = 5, 4
    # two frames a rank, so the frame stack of one launch is exercised
    H, W, B = 8 * rows, 32, 2 * batch
    rng = np.random.default_rng(0)
    img1 = rng.integers(0, 256, (B, H, W, 3), np.uint8)
    img2 = np.roll(img1, -2, axis=2)

    ir, ib = mesh.get_local_rank("rows"), mesh.get_local_rank("batch")
    hl, bl, halo = H // rows, B // batch, WIN // 2

    def block(a):
        return torch.as_tensor(a[ib * bl:(ib + 1) * bl,
                                 ir * hl:(ir + 1) * hl], device=dev)

    e1, valid = halo_exchange_rows(block(img1), halo, mesh, "rows", 1)
    e2, _ = halo_exchange_rows(block(img2), halo, mesh, "rows", 1)
    d = asw_disparity_batch(e1, e2, win_size=WIN, max_disp=MAXD,
                            consistent=True,
                            row_valid=valid.expand(bl, -1))[:, halo:-halo]
    stats = torch.stack([d.to(torch.float32).sum(),
                         torch.tensor(float(d.numel()), device=dev)])
    all_reduce(stats, mesh, ("rows", "batch"))
    disp = all_gather_cat(all_gather_cat(d, mesh, "rows", 1), mesh,
                          "batch", 0)
    mean = (stats[0] / stats[1]).item()
    assert tuple(disp.shape) == (B, H, W)
    assert np.isfinite(mean)
    out = dict(disp=disp, mean_disp=mean)

    # tiled SGM: the wavefront's carries cross the row tiles
    rmesh = make_mesh({"rows": n_devices}, device_type=device_type)
    Hs = 8 * n_devices
    s1 = rng.integers(0, 256, (Hs, 32, 3), np.uint8)
    s2 = np.roll(s1, -2, axis=1)
    out["sgm"] = tiled_sgm_disparity(s1, s2, rmesh, num_disp=8)
    assert tuple(out["sgm"].shape) == (Hs, 32)
    # tiled GSW: halo rows with the sentinel
    out["gsw"] = tiled_gsw_disparity(s1, s2, rmesh, win_size=WIN,
                                     max_disp=MAXD, consistent=True)
    assert tuple(out["gsw"].shape) == (Hs, 32)

    # the mesh Gauss-Newton: S and g summed over the ranks
    vmesh = make_mesh({"views": n_devices}, device_type=device_type)
    xx, yy = np.meshgrid(np.arange(4, dtype=float), np.arange(3, dtype=float))
    obj = np.stack([xx.ravel() * 60, yy.ravel() * 60, np.zeros(12)], 1)
    K0 = np.array([[800.0, 0, 320], [0, 800.0, 240], [0, 0, 1]])
    views = []
    for v in range(2 * n_devices):
        rvec = 0.1 * rng.normal(size=3)
        tvec = np.array([-90.0, -75.0, 800.0 + 10 * v])
        views.append(ba.project_points(
            obj, rvec, tvec, K0[0, 0], K0[1, 1], K0[0, 2], K0[1, 2],
            np.zeros(5)))
    rms, _, _, poses = calibrate_camera_sharded(
        np.tile(obj[None], (2 * n_devices, 1, 1)), np.stack(views), K0,
        np.zeros(5), vmesh, axis="views", iterations=2)
    assert np.isfinite(rms) and poses.shape == (2 * n_devices, 6)
    out["ba_rms"] = rms

    # the sharded FTP: distributed y-unwrap and summed fringe order
    if 96 % n_devices == 0:
        ftp, img, _ = ftp_scene(dev)
        cloud = sharded_ftp_cloud(ftp, img, rmesh)
        assert cloud.shape == (96, 128, 3)
        assert np.isfinite(cloud[..., 2]).mean() > 0.5
        out["ftp"] = cloud
    return out


# -- a world of processes on this host ---------------------------------------

def _resolve(path):
    """The function at ``path`` below this package, e.g.
    ``"parallel.tiled_asw_disparity"``."""
    mod, name = f"simplestereo_tpu_torch.{path}".rsplit(".", 1)
    return getattr(importlib.import_module(mod), name)


def _to_numpy(x):
    return pytree.tree_map(
        lambda v: v.cpu().numpy() if isinstance(v, torch.Tensor) else v, x)


def _run_job(job):
    """One job: ``fn`` (a path below the package), ``args``, ``kwargs``,
    optional ``mesh`` axis sizes (passed as ``mesh=``) over optional
    ``devices`` (ranks; a rank off that mesh skips the call) and ``call``
    (the result is called with these arguments). Returns ("ok", result as
    numpy), ("skipped",) or ("error", exception type name, message,
    traceback)."""
    try:
        kw = dict(job.get("kwargs", {}))
        if job.get("mesh") is not None:
            kw["mesh"] = make_mesh(job["mesh"], job.get("devices"),
                                   device_type="cpu")
            if kw["mesh"].get_coordinate() is None:
                return ("skipped",)
        out = _resolve(job["fn"])(*job.get("args", ()), **kw)
        if job.get("call") is not None:
            out = out(*job["call"])
        return ("ok", _to_numpy(out))
    except Exception as e:  # noqa: BLE001 (returned to the caller)
        return ("error", type(e).__name__, str(e), traceback.format_exc())


def _rank_main(rank, world_size, port, tasks, results):
    """Body of one spawned rank: take the jobs from ``tasks``, join the
    world, run the jobs on one intra-op thread (the ranks share the host's
    cores); rank 0 puts the results on ``results``, and any failure is put
    there too."""
    for name in ("jax", "simplestereo_tpu"):
        sys.modules[name] = None  # a rank runs without JAX
    try:
        jobs = tasks.get()
        torch.set_num_threads(1)
        init_distributed("cpu", world_size=world_size, rank=rank,
                         init_method=f"tcp://localhost:{port}")
        out = [_run_job(job) for job in jobs]
        dist.barrier()
        if rank == 0:
            results.put(("ok", out))
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 (reported to the parent)
        results.put(("failed", rank, traceback.format_exc()))


def spawn(jobs, world_size, *, timeout=120.0):
    """Run ``jobs`` in a new world of ``world_size`` gloo processes on this
    host and return rank 0's results, one a job (see :func:`_run_job`).

    The ranks are started with the ``spawn`` method (they import torch
    and this package only), join through a free localhost port and run
    every job in order; a job that raises the same error on every rank
    returns it as its result. Raises RuntimeError when a rank fails or
    dies and TimeoutError when the world has not finished within
    ``timeout`` seconds; every rank is killed before this returns or
    raises.
    """
    ctx = multiprocessing.get_context("spawn")
    tasks, results = ctx.Queue(), ctx.Queue()
    port = free_port()
    # The jobs go through a queue, not the process arguments: a start()
    # whose arguments fill the pipe waits for the child to import torch.
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        rank, world_size, port, tasks, results))
        for rank in range(world_size)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
            tasks.put(jobs)
        while True:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"a world of {world_size} ranks did not "
                                   f"finish within {timeout} s")
            try:
                msg = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p.exitcode for p in procs if p.exitcode]
                if dead:
                    raise RuntimeError(f"a rank died (exit codes {dead})")
                continue
            if msg[0] == "failed":
                raise RuntimeError(f"rank {msg[1]} failed:\n{msg[2]}")
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
            return msg[1]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(5)
        tasks.close()
        results.close()


def main(argv=None):
    """``torchrun`` entry: run the named paths on a ``{"rows": world}``
    mesh ("dryrun" runs :func:`dryrun_multichip`)."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("paths", nargs="*", default=["dryrun", *PATHS])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--consistent", action="store_true")
    args = ap.parse_args(argv)
    if "WORLD_SIZE" in os.environ:
        rank, world = init_distributed(args.device)
    else:  # plain python: an explicit world of one
        rank, world = init_distributed(args.device, world_size=1, rank=0)
    mesh = make_mesh({"rows": world}, device_type=args.device)
    for name in args.paths:
        if name == "dryrun":
            dryrun_multichip(world, args.device)
            detail = "steps=asw,sgm,gsw,ba,ftp"
        else:
            detail = PATHS[name](mesh, args.consistent)
        if rank == 0:
            print(f"MULTIHOST-OK path={name} {detail} ranks={world} "
                  f"device={args.device}", flush=True)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
