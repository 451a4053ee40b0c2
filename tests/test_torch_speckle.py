"""SGM's speckle filter on the card: the kernels of
``speckle_cuda.filter_speckles`` (``csrc/speckle_kernel.cu``) and their
twin, the host function ``sgm.filter_speckles``, and where
``StereoSGM`` runs each.

On the CPU: the kernels' four launches, emulated one thread after another
in numpy (the tiles, the border pairs as the kernel numbers them, the tile
roots' counts, the two hops to a root), equal the host function; numpy and
CPU maps take the host function; a matcher with ``speckleWindowSize`` 0
runs no filter and opens no ``sgm.speckle`` span; a tensor pair gives the
numpy path's map. Tests marked ``card`` run the kernels and skip without a
CUDA card. This file imports no JAX, so on the card it runs as

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_speckle.py
"""

import math

import numpy as np
import pytest
import torch

import simplestereo_tpu_torch as tss
from cuda_card import card  # noqa: F401 (the fixture)
from simplestereo_tpu_torch.passive import sgm, speckle_cuda

TILE_H, TILE_W = 16, 32  # csrc/speckle_kernel.cu: kTileH, kTileW

# (H, W): one tile, ragged tiles, a row, a column, many tiles
SHAPES = [(5, 7), (16, 32), (17, 33), (40, 70), (1, 97), (97, 1), (48, 96)]
MAX_DIFFS = [1, 16, 32]
SIZES = [1, 2, 120, 10**6]  # the last larger than every map


def blob_map(h, w, seed, lo=-40, hi=200):
    """(h, w) int16 disparity x 16 map of blobs: a coarse random field
    blown up by a random cell size, with noise, so blobs of every size and
    negative values appear, and neighbours straddle the quantum's
    boundaries."""
    rng = np.random.default_rng(seed)
    cell = int(rng.integers(1, 6))
    coarse = rng.integers(lo, hi, (h // cell + 2, w // cell + 2))
    d = np.repeat(np.repeat(coarse, cell, 0), cell, 1)[:h, :w]
    d = d + rng.integers(-3, 4, (h, w)) * (rng.random((h, w)) < 0.3)
    return d.astype(np.int16)


def two_level_map(h, w, seed):
    """(h, w) int16 map of two quantised values in random blocks and
    noise: components that wind across many tiles and meet at their
    corners."""
    rng = np.random.default_rng(seed)
    cell = int(rng.integers(1, 9))
    coarse = rng.random((h // cell + 2, w // cell + 2)) < 0.5
    d = np.repeat(np.repeat(coarse, cell, 0), cell, 1)[:h, :w]
    d ^= rng.random((h, w)) < 0.1
    return (d * 32 + rng.integers(0, 16, (h, w))).astype(np.int16)


def kernel_phases(d, new_val, max_speckle_size, max_diff):
    """csrc/speckle_kernel.cu's four launches on one (H, W) map, one
    thread after another, with the wrapper's m and size: the runs, the
    unions each kernel makes, the counts."""
    H, W = d.shape
    m = min(max(int(max_diff), 1), 2**16)
    size = min(max(math.ceil(max_speckle_size), 0), H * W + 1)
    q = np.floor_divide(d.astype(np.int64), m).reshape(H, W)
    label = np.arange(H * W)

    def find(x):
        while label[x] != x:
            x = label[x]
        return x

    def unite(a, b):
        a, b = find(a), find(b)
        label[max(a, b)] = min(a, b)

    # speckle_local_kernel: runs of equal q along a tile row, then one
    # union where two runs first touch across the rows of a tile
    for y in range(H):
        for x in range(W):
            if x % TILE_W and q[y, x - 1] == q[y, x]:
                label[y * W + x] = label[y * W + x - 1]
    for y in range(H):
        for x in range(W):
            left = x % TILE_W and q[y, x - 1] == q[y, x]
            if (y % TILE_H and q[y - 1, x] == q[y, x]
                    and not (left and q[y - 1, x - 1] == q[y, x])):
                unite(y * W + x, (y - 1) * W + x)
    label = np.array([find(p) for p in range(H * W)])
    count = np.bincount(label, minlength=H * W)
    # speckle_border_kernel: the pairs across the borders, as numbered
    qf = q.ravel()
    tiles_x, tiles_y = -(-W // TILE_W), -(-H // TILE_H)
    nv = (tiles_x - 1) * H
    for i in range(nv + (tiles_y - 1) * W):
        if i < nv:
            k, y = divmod(i, H)
            a = y * W + TILE_W * (k + 1)
            b = a - 1
        else:
            k, x = divmod(i - nv, W)
            a = TILE_H * (k + 1) * W + x
            b = a - W
        if qf[a] == qf[b]:
            unite(a, b)
    # speckle_roots_kernel: tile roots count into their roots
    for p in np.flatnonzero(count):
        root = find(p)
        if root != p:
            label[p] = root
            count[root] += count[p]
    # speckle_write_kernel
    root = np.array([find(p) for p in range(H * W)])
    out = np.where(count[root] < size, new_val, d.ravel())
    return out.reshape(H, W).astype(np.int16)


GRID = [(shape, md, size) for shape in SHAPES for md in MAX_DIFFS
        for size in SIZES]


@pytest.mark.parametrize("shape,max_diff,size", GRID,
                         ids=[f"{h}x{w}-md{md}-s{s}"
                              for (h, w), md, s in GRID])
def test_kernel_phases_equal_the_host_filter(shape, max_diff, size):
    d = blob_map(*shape, seed=shape[0] * 1000 + shape[1] + max_diff)
    got = kernel_phases(d, -16, size, max_diff)
    np.testing.assert_array_equal(
        got, sgm.filter_speckles(d, -16, size, max_diff))


@pytest.mark.parametrize("shape", [(33, 65), (48, 96)])
@pytest.mark.parametrize("seed", range(6))
def test_kernel_phases_on_two_levels(shape, seed):
    d = two_level_map(*shape, seed)
    for size in (3, 40):
        np.testing.assert_array_equal(kernel_phases(d, -16, size, 16),
                                      sgm.filter_speckles(d, -16, size, 16))


def test_kernel_phases_on_one_value_and_on_a_chequer():
    """The whole map one component, then every pixel its own."""
    flat = np.full((33, 65), 37, np.int16)
    np.testing.assert_array_equal(kernel_phases(flat, 0, 33 * 65, 1),
                                  sgm.filter_speckles(flat, 0, 33 * 65, 1))
    cheq = (np.indices((33, 65)).sum(0) % 2 * 16).astype(np.int16)
    np.testing.assert_array_equal(kernel_phases(cheq, -16, 2, 16),
                                  np.full((33, 65), -16, np.int16))


def _matcher(speckle=120, device="cpu", **kw):
    return tss.passive.StereoSGM(minDisparity=1, numDisparities=16,
                                 blockSize=7, disp12MaxDiff=1,
                                 speckleWindowSize=speckle, device=device,
                                 **kw)


def _pair(h=24, w=64, shift=5, seed=19):
    rng = np.random.default_rng(seed)
    left = rng.integers(0, 256, (h, w + shift, 3)).astype(np.uint8)
    return np.ascontiguousarray(left[:, shift:]), \
        np.ascontiguousarray(left[:, :w])


def _forbid_kernels(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("a CPU map reached the speckle kernels")
    monkeypatch.setattr(speckle_cuda, "filter_speckles", refuse)


def _spy_host(monkeypatch):
    calls = []
    real = sgm.filter_speckles

    def spy(d, *args):
        calls.append(np.asarray(d).shape)
        return real(d, *args)
    monkeypatch.setattr(sgm, "filter_speckles", spy)
    return calls


@pytest.mark.parametrize("kind", ["numpy", "cpu tensor"])
@pytest.mark.parametrize("lead", [(), (3,)])
def test_cpu_and_numpy_maps_take_the_host_filter(monkeypatch, kind, lead):
    maps = np.stack([blob_map(20, 40, seed=s) for s in range(3)])
    maps = maps if lead else maps[0]
    want = np.stack([sgm.filter_speckles(d, 0, 6, 16)
                     for d in maps.reshape(-1, 20, 40)]).reshape(maps.shape)
    _forbid_kernels(monkeypatch)
    calls = _spy_host(monkeypatch)
    m = _matcher(speckle=6, speckleRange=1)
    got = m._speckles(torch.tensor(maps) if kind == "cpu tensor" else maps)
    assert isinstance(got, torch.Tensor) == (kind == "cpu tensor")
    assert calls == [(20, 40)] * (3 if lead else 1)
    got = np.asarray(got)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, want)


def _spans(fn):
    """Names of the record_function ranges ``fn`` opened."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


@pytest.mark.parametrize("call", ["compute", "compute tensors",
                                  "computeBatch"])
def test_speckle_zero_runs_nothing_new(monkeypatch, call):
    _forbid_kernels(monkeypatch)
    calls = _spy_host(monkeypatch)
    m = _matcher(speckle=0)
    left, right = _pair()
    run = {"compute": lambda: m.compute(left, right),
           "compute tensors": lambda: m.compute(torch.tensor(left),
                                                torch.tensor(right)),
           "computeBatch": lambda: m.computeBatch(left[None], right[None])}
    names = _spans(run[call])
    assert "match" in names and "sgm.post" in names
    assert "sgm.speckle" not in names and calls == []


@pytest.mark.parametrize("call", ["compute", "compute tensors",
                                  "computeBatch"])
def test_the_filter_runs_inside_match(monkeypatch, call):
    """With speckles, each call path filters under ``sgm.speckle``, inside
    ``match``: the readback copies the filtered map."""
    calls = _spy_host(monkeypatch)
    m = _matcher()
    left, right = _pair()
    run = {"compute": lambda: m.compute(left, right),
           "compute tensors": lambda: m.compute(torch.tensor(left),
                                                torch.tensor(right)),
           "computeBatch": lambda: m.computeBatch(np.stack([left] * 2),
                                                  np.stack([right] * 2))}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run[call]()
    ev = {e.name: e for e in prof.events()
          if e.name in ("match", "sgm.speckle", "readback")}
    assert "sgm.speckle" in ev and len(calls) == (2 if call == "computeBatch"
                                                   else 1)
    sp, mt = ev["sgm.speckle"].time_range, ev["match"].time_range
    assert mt.start <= sp.start and sp.end <= mt.end
    if "readback" in ev:
        assert ev["readback"].time_range.start >= sp.end


def test_tensor_path_equals_numpy_path():
    m = _matcher(speckle=40)
    left, right = _pair(seed=23)
    want = m.compute(left, right)
    got = m.compute(torch.tensor(left), torch.tensor(right))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    lefts = np.stack([left, np.roll(left, 3, 0), np.roll(left, 5, 1)])
    rights = np.stack([right, np.roll(right, 3, 0), np.roll(right, 5, 1)])
    batch = m.computeBatch(lefts, rights)
    for i in range(3):
        np.testing.assert_array_equal(batch[i],
                                      m.compute(lefts[i], rights[i]))


def test_filtered_map_is_the_host_filter_of_the_raw_map():
    left, right = _pair(seed=29)
    raw = _matcher(speckle=0).compute(left, right)
    np.testing.assert_array_equal(
        _matcher(speckle=120).compute(left, right),
        sgm.filter_speckles(raw, 0, 120, 32))


@pytest.mark.parametrize("bad", ["cpu", "int32", "one dim", "new_val"])
def test_the_wrapper_refuses(bad):
    d = torch.zeros((4, 5), dtype=torch.int16)
    args = (-16, 10, 16)
    if bad == "int32":
        d = d.to(torch.int32)
    elif bad == "one dim":
        d = d[0]
    elif bad == "new_val":
        args = (40000, 10, 16)
    n = speckle_cuda.speckle_launches
    with pytest.raises(ValueError):
        speckle_cuda.filter_speckles(d, *args)
    assert speckle_cuda.speckle_launches == n


# -- on the card ------------------------------------------------------------

def _on_card(card, d, *args):
    n = speckle_cuda.speckle_launches
    got = speckle_cuda.filter_speckles(torch.tensor(d, device=card), *args)
    torch.cuda.synchronize(card)
    assert speckle_cuda.speckle_launches == n + 1
    assert got.dtype == torch.int16 and got.shape == d.shape
    return got.cpu()


CARD_SHAPES = SHAPES + [(1, 2049), (2049, 1), (720, 1280), (333, 517)]
CARD_GRID = [(shape, md, size) for shape in CARD_SHAPES for md in MAX_DIFFS
             for size in SIZES]


@pytest.mark.card
@pytest.mark.parametrize("shape,max_diff,size", CARD_GRID,
                         ids=[f"{h}x{w}-md{md}-s{s}"
                              for (h, w), md, s in CARD_GRID])
def test_kernels_equal_the_host_filter(card, shape, max_diff, size):
    d = blob_map(*shape, seed=shape[0] * 7 + shape[1] + max_diff)
    want = sgm.filter_speckles(d, -16, size, max_diff)
    assert torch.equal(_on_card(card, d, -16, size, max_diff),
                       torch.from_numpy(want))


@pytest.mark.card
@pytest.mark.parametrize("shape", [(48, 96), (333, 517), (720, 1280)])
@pytest.mark.parametrize("seed", range(8))
def test_kernels_on_two_levels(card, shape, seed):
    d = two_level_map(*shape, seed)
    for size in (3, 40, 5000):
        want = sgm.filter_speckles(d, -16, size, 16)
        assert torch.equal(_on_card(card, d, -16, size, 16),
                           torch.from_numpy(want))


@pytest.mark.card
@pytest.mark.parametrize("frames", [1, 8])
def test_a_stack_is_each_map_alone(card, frames):
    maps = np.stack([blob_map(45, 150, seed=100 + i) for i in range(frames)])
    got = _on_card(card, maps, -16, 40, 16)
    want = np.stack([sgm.filter_speckles(d, -16, 40, 16) for d in maps])
    assert torch.equal(got, torch.from_numpy(want))


@pytest.mark.card
def test_many_frames_in_two_launches(card):
    """70,000 frames: the grid's y holds 65,535, so two pieces."""
    maps = np.stack([blob_map(3, 5, seed=i % 97) for i in range(70_000)])
    got = _on_card(card, maps, -16, 3, 16)
    for lo in (0, 65_500):
        want = np.stack([sgm.filter_speckles(d, -16, 3, 16)
                         for d in maps[lo:lo + 97]])
        assert torch.equal(got[lo:lo + 97], torch.from_numpy(want))


# The lawn stand-in of the benchmark's SGM cells: a background at 45 and
# layers at 6..94 inside candidates 1..96.
LAWN = (45, [(6, 0.00, 1.00, 0.00, 0.15), (58, 0.08, 0.30, 0.30, 0.75),
             (70, 0.60, 0.85, 0.20, 0.55), (83, 0.35, 0.55, 0.55, 0.90),
             (94, 0.75, 0.92, 0.65, 0.95)])


def layered_pair(h, w, seed, scene=LAWN):
    """(left, right) uint8 BGR views of fronto-parallel textured layers at
    integer disparities (far to near, the nearer occluding)."""
    rng = np.random.default_rng(seed)
    bg, layers = scene
    boxes = [(bg, 0, w, 0, h)] + [
        (d, round(x0 * w), round(x1 * w), round(y0 * h), round(y1 * h))
        for d, x0, x1, y0, y1 in layers]
    pad = max(b[0] for b in boxes) + 2
    ys, xs = np.mgrid[0:h, 0:w]
    top_l = np.zeros((h, w), int)
    top_r = np.zeros((h, w), int)
    for i, (d, x0, x1, y0, y1) in enumerate(boxes):
        rows = (ys >= y0) & (ys < y1)
        top_l[rows & (xs >= x0) & (xs < x1)] = i
        top_r[rows & (xs + d >= x0) & (xs + d < x1)] = i
    tex = rng.integers(0, 256, (len(boxes), h + 2, w + pad + 2, 3))
    tex = sum(tex[:, i:i + h, j:j + w + pad] for i in range(3)
              for j in range(3)) // 9
    disp = np.array([b[0] for b in boxes])
    left = tex[top_l, ys, xs].astype(np.uint8)
    right = tex[top_r, ys, xs + disp[top_r]].astype(np.uint8)
    return left, right


@pytest.mark.card
@pytest.mark.parametrize("frames", [1, 8])
def test_bt_sgm_maps_at_720p(card, frames):
    """Example 011's matcher on the card: each call filters there (one
    launch set a call), and its maps are the host filter of the same
    matcher's unfiltered maps."""
    pairs = [layered_pair(720, 1280, seed=300 + i) for i in range(frames)]
    lefts = np.stack([a for a, _ in pairs])
    rights = np.stack([b for _, b in pairs])
    kw = dict(minDisparity=1, numDisparities=96, blockSize=7,
              disp12MaxDiff=1, device="cuda")
    raw = tss.passive.StereoSGM(**kw).computeBatch(lefts, rights)
    m = tss.passive.StereoSGM(speckleWindowSize=120, **kw)
    n = speckle_cuda.speckle_launches
    got = (m.compute(lefts[0], rights[0])[None] if frames == 1
           else m.computeBatch(lefts, rights))
    assert speckle_cuda.speckle_launches == n + 1
    want = np.stack([sgm.filter_speckles(d, 0, 120, 32) for d in raw])
    assert (want != raw).any()  # the filter has work to do
    np.testing.assert_array_equal(got, want)
    on_card = m.compute(torch.tensor(lefts[0], device=card),
                        torch.tensor(rights[0], device=card))
    assert on_card.device == card
    assert torch.equal(on_card.cpu(), torch.from_numpy(want[0]))


@pytest.mark.card
def test_example_011_maps_at_720p(card):
    """The kernels on example 011's BT SGM maps of the stand-in resource
    tree's layered scenes (tests/torch_example_res.py) at 1280x720, one
    frame and 8, called directly and through the matcher's ``compute``
    and ``computeBatch`` (one launch set a call): each map the host
    filter's."""
    import torch_example_res as res
    scenes = [res.tsukuba_scene((1280, 720), seed=40 + i)[:2]
              for i in range(8)]
    lefts = np.stack([a for a, _ in scenes])
    rights = np.stack([b for _, b in scenes])
    kw = dict(minDisparity=1, numDisparities=96, blockSize=7,
              disp12MaxDiff=1, device="cuda")
    raw = tss.passive.StereoSGM(**kw).computeBatch(lefts, rights)
    args = (0, 120, 32)  # (minDisparity - 1) * 16, 120, speckleRange * 16
    host = np.stack([sgm.filter_speckles(d, *args) for d in raw])
    assert (host != raw).any()  # the filter has work to do
    for frames in (1, 8):
        assert torch.equal(_on_card(card, raw[:frames], *args),
                           torch.from_numpy(host[:frames]))
    m = tss.passive.StereoSGM(speckleWindowSize=120, **kw)
    n = speckle_cuda.speckle_launches
    one = m.compute(lefts[0], rights[0])
    batch = m.computeBatch(lefts, rights)
    assert speckle_cuda.speckle_launches == n + 2
    np.testing.assert_array_equal(one, host[0])
    np.testing.assert_array_equal(batch, host)
