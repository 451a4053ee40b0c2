"""PyTorch port: ``parallel`` on torch.distributed (ASW, the mesh helpers)
and the SGM kernel twin's direction families with a carry, on the CPU.

The JAX functions run on the conftest's 8-device virtual mesh; the port
runs in a world of 8 gloo processes spawned once for the module
(``parallel.dryrun.spawn``: every rank imports torch and the port only,
joins through a free localhost port and is killed after 240 s at most),
on the same numpy inputs made from a seed.

Gates:
- tiled ASW (rows 8; rows 4 x batch 2; consistent or not): bit-equal to
  the port's own single-frame matcher, and within the JAX package's own
  0.5% tiled-vs-single gate (tests/test_parallel.py) of JAX's
  single-device map (JAX's tiled programs take about 7 s each to compile
  here; its own tests hold them to that gate);
- ``batch_parallel`` and ``psum_stats``: exact;
- ``make_mesh`` with a wrong size, rows that do not divide, and a halo
  taller than a tile raise ValueError in every rank; a CUDA mesh without a
  card raises RuntimeError;
- the SGM twin (``sgm_cuda._aggregate`` with ``directions`` and
  ``carry``): each of the 6 vertical and diagonal directions alone from a
  non-zero carry bit-equal to a float32 numpy loop of the recurrence; a
  chain of carried tiles ``torch.equal`` to the whole volume's buffers;
  and equal to JAX's ``_vertical_wavefront`` on 2 and 4 devices.
"""

import functools

import numpy as np
import pytest
import torch

import jax
from jax import shard_map
from jax.sharding import PartitionSpec as P

from simplestereo_tpu import parallel as jparallel
from simplestereo_tpu.passive import asw_disparity as jax_asw
from simplestereo_tpu.passive import asw_disparity_batch as jax_asw_batch
from simplestereo_tpu.parallel.sgm import _vertical_wavefront
from simplestereo_tpu_torch import parallel
from simplestereo_tpu_torch.parallel import dryrun
from simplestereo_tpu_torch.passive import sgm_cuda
from simplestereo_tpu_torch.passive.asw_cuda import asw_disparity

ASW = dict(win_size=5, max_disp=4, min_disp=0)


def _pair(seed, shape, shift=2):
    img1 = np.random.default_rng(seed).integers(0, 256, shape, np.uint8)
    return img1, np.roll(img1, -shift, axis=-2)


SINGLE = {c: _pair(42, (32, 40, 3)) for c in (False, True)}
BATCH = _pair(43, (4, 16, 40, 3))
STATS = np.arange(16, dtype=np.float32).reshape(8, 2)
BATCHED = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4)

JOBS = {}
for _c in (False, True):
    JOBS[f"asw{int(_c)}"] = dict(
        fn="parallel.tiled_asw_disparity", mesh={"rows": 8},
        args=SINGLE[_c], kwargs=dict(consistent=_c, **ASW))
    JOBS[f"batch{int(_c)}"] = dict(
        fn="parallel.tiled_asw_disparity_batch",
        mesh={"rows": 4, "batch": 2}, args=BATCH,
        kwargs=dict(consistent=_c, **ASW))
JOBS.update(
    batch_parallel=dict(fn="parallel.batch_parallel",
                        mesh={"rows": 4, "batch": 2}, args=(torch.square,),
                        kwargs=dict(batch_axis="batch"), call=(BATCHED,)),
    psum=dict(fn="parallel.psum_stats", mesh={"rows": 4, "batch": 2},
              args=(STATS,), kwargs=dict(axis_names=("rows", "batch"))),
    bad_mesh=dict(fn="parallel.make_mesh", args=({"rows": 3},),
                  kwargs=dict(device_type="cpu")),
    bad_rows=dict(fn="parallel.tiled_asw_disparity",
                  mesh={"rows": 4, "batch": 2},
                  args=(np.zeros((30, 16, 3), np.uint8),) * 2,
                  kwargs=dict(win_size=5)),
    tall_halo=dict(fn="parallel.tiled_asw_disparity", mesh={"rows": 8},
                   args=(np.zeros((16, 16, 3), np.uint8),) * 2,
                   kwargs=dict(win_size=7)),
)


@pytest.fixture(scope="module")
def world8():
    out = dryrun.spawn(list(JOBS.values()), 8, timeout=240)
    return dict(zip(JOBS, out))


def _ok(res):
    assert res[0] == "ok", res[1:]
    return res[1]


@pytest.mark.parametrize("consistent", [False, True])
def test_tiled_asw_matches_single_and_jax(world8, consistent):
    img1, img2 = SINGLE[consistent]
    kw = dict(consistent=consistent, **ASW)
    tiled = _ok(world8[f"asw{int(consistent)}"])
    single = asw_disparity(torch.tensor(img1), torch.tensor(img2), **kw)
    np.testing.assert_array_equal(tiled, single.numpy())
    want = np.asarray(jax_asw(img1, img2, **kw))
    assert tiled.dtype == want.dtype and tiled.shape == want.shape
    assert (tiled != want).mean() <= 0.005


@pytest.mark.parametrize("consistent", [False, True])
def test_tiled_asw_batch_matches_single_and_jax(world8, consistent):
    imgs1, imgs2 = BATCH
    kw = dict(consistent=consistent, **ASW)
    tiled = _ok(world8[f"batch{int(consistent)}"])
    assert tiled.shape == (4, 16, 40)
    for i in range(4):
        single = asw_disparity(torch.tensor(imgs1[i]), torch.tensor(imgs2[i]),
                               **kw)
        np.testing.assert_array_equal(tiled[i], single.numpy())
    want = np.asarray(jax_asw_batch(imgs1, imgs2, **kw))
    assert (tiled != want).mean() <= 0.005


def test_batch_parallel_and_psum_stats(world8):
    np.testing.assert_array_equal(_ok(world8["batch_parallel"]),
                                  BATCHED ** 2)
    s, c = _ok(world8["psum"])
    jmesh = jparallel.make_mesh({"rows": 4, "batch": 2})
    js, jc = np.asarray(jparallel.psum_stats(STATS, jmesh, ("rows", "batch")))
    assert s == js == STATS.sum() and c == jc == STATS.size


@pytest.mark.parametrize("job,words", [
    ("bad_mesh", "needs 3 ranks"), ("bad_rows", "not divisible"),
    ("tall_halo", "H / n = 2")])
def test_bad_shapes_raise(world8, job, words):
    res = world8[job]
    assert res[:2] == ("error", "ValueError") and words in res[2], res[:3]


def test_cuda_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="needs a card"):
        parallel.make_mesh({"rows": 1})
    with pytest.raises(RuntimeError, match="needs a card"):
        parallel.init_distributed("cuda", world_size=1, rank=0)


# -- the SGM twin's families and carries --------------------------------------

P1, P2 = np.float32(7.0), np.float32(30.0)


def _volume(seed, h, w, d):
    return np.random.default_rng(seed).integers(0, 60, (h, w, d)).astype(
        np.float32)


def _direction_loop(C, dy, dx, carry):
    """One direction's L over an (H, W, D) tile in float32 numpy, pixel by
    pixel: the predecessor of the first row is carry[x - dx] (zero off the
    tile), of a later row L at (y - dy, x - dx)."""
    H, W, D = C.shape
    L = np.zeros_like(C)
    zero = np.zeros(D, np.float32)
    rows = list(range(H)) if dy > 0 else list(range(H - 1, -1, -1))
    for i, y in enumerate(rows):
        for x in range(W):
            xp = x - dx
            if not 0 <= xp < W:
                lp = zero
            elif i == 0:
                lp = carry[xp]
            else:
                lp = L[y - dy, xp]
            m = lp.min()
            up = np.concatenate([lp[1:], lp[-1:]])
            dn = np.concatenate([lp[:1], lp[:-1]])
            best = np.minimum(np.minimum(lp, np.minimum(up, dn) + P1),
                              m + P2)
            L[y, x] = (C[y, x] + best) - m
    return L


# kernel direction number -> (family, index in it, dy, dx)
DIRECTIONS = {2: ("down", 0, 1, 0), 3: ("up", 0, -1, 0),
              4: ("down", 1, 1, 1), 5: ("up", 1, -1, 1),
              6: ("down", 2, 1, -1), 7: ("up", 2, -1, -1)}


@pytest.mark.parametrize("direction", sorted(DIRECTIONS))
def test_twin_direction_from_a_carry(direction):
    family, j, dy, dx = DIRECTIONS[direction]
    C = _volume(direction, 7, 11, 6)
    carry = np.random.default_rng(50 + direction).integers(
        0, 90, (3, 11, 6)).astype(np.float32)
    L = sgm_cuda._aggregate(torch.tensor(C), float(P1), float(P2), 8,
                            directions=family, carry=torch.tensor(carry))
    np.testing.assert_array_equal(L[direction].numpy(),
                                  _direction_loop(C, dy, dx, carry[j]))


@pytest.mark.parametrize("paths,bounds", [(8, (0, 5, 6, 13)),
                                          (4, (0, 9, 13))])
def test_twin_tile_chain_equals_whole(paths, bounds):
    C = torch.tensor(_volume(7, 13, 10, 5))
    whole = sgm_cuda.aggregate(C, float(P1), float(P2), paths,
                               directions="horizontal")
    for fam in ("down", "up"):
        sgm_cuda.aggregate(C, float(P1), float(P2), paths, directions=fam,
                           out=whole)
    np.testing.assert_array_equal(
        sgm_cuda.sum_paths(whole).numpy(),
        sgm_cuda.aggregate(C, float(P1), float(P2), paths).numpy())
    tiles = [C[a:b].contiguous() for a, b in zip(bounds, bounds[1:])]
    Ls = [sgm_cuda.aggregate(t, float(P1), float(P2), paths,
                             directions="horizontal") for t in tiles]
    for fam, order in (("down", range(len(tiles))),
                       ("up", reversed(range(len(tiles))))):
        carry = None
        for i in order:
            sgm_cuda.aggregate(tiles[i], float(P1), float(P2), paths,
                               directions=fam, carry=carry, out=Ls[i])
            carry = sgm_cuda.carry_of(Ls[i], fam, paths)
    assert torch.equal(torch.cat(Ls, dim=1), whole)


@pytest.mark.parametrize("n", [2, 4])
def test_twin_chain_matches_jax_wavefront(n):
    rolls = (0, 1, -1)
    C = _volume(9, 4 * n, 12, 5)
    jmesh = jparallel.make_mesh({"rows": n}, devices=jax.devices()[:n])
    run = functools.partial(
        shard_map, mesh=jmesh, in_specs=P("rows"),
        out_specs=(P(None, "rows"), P(None, "rows")), check_vma=False)(
        lambda c: _vertical_wavefront(c, float(P1), float(P2), rolls,
                                      "rows"))
    od, ou = (np.asarray(a) for a in run(C))
    # JAX keeps each tile's upward scan in flipped row order
    ou = ou.reshape(3, n, 4, 12, 5)[:, :, ::-1].reshape(3, 4 * n, 12, 5)
    tiles = [torch.tensor(C[4 * i:4 * i + 4]) for i in range(n)]
    Ls = [torch.zeros((8, 4, 12, 5)) for _ in range(n)]
    for fam, order in (("down", range(n)), ("up", reversed(range(n)))):
        carry = None
        for i in order:
            sgm_cuda._aggregate(tiles[i], float(P1), float(P2), 8,
                                directions=fam, carry=carry, out=Ls[i])
            carry = sgm_cuda.carry_of(Ls[i], fam, 8)
    L = torch.cat(Ls, dim=1).numpy()
    np.testing.assert_array_equal(L[[2, 4, 6]], od)
    np.testing.assert_array_equal(L[[3, 5, 7]], ou)


def test_family_arguments_are_checked():
    C = torch.zeros((4, 5, 3))
    with pytest.raises(ValueError, match="directions"):
        sgm_cuda.aggregate(C, 1.0, 2.0, 8, directions="left")
    with pytest.raises(ValueError, match="carry"):
        sgm_cuda.aggregate(C, 1.0, 2.0, 8, carry=torch.zeros((3, 5, 3)))
    with pytest.raises(ValueError, match="carry"):
        sgm_cuda.aggregate(C, 1.0, 2.0, 8, directions="down",
                           carry=torch.zeros((1, 5, 3)))
    with pytest.raises(ValueError, match="out"):
        sgm_cuda.aggregate(C, 1.0, 2.0, 4, directions="up",
                           out=torch.zeros((8, 4, 5, 3)))
