"""Layered stereo scenes from a seed: the benchmark's inputs.

A frozen copy of the Tsukuba stand-in of the port's example tests
(``tsukuba_scene``), widened to take its layers from the traffic file,
with each texture drawn over its own layer only: fronto-parallel
rectangles at integer disparities, listed far to near,
each with band-limited noise of its own (uniform noise under a 3 x 3 box
blur, about 2 px a texel) fixed in the left view's coordinates. A right
pixel x sees, of the layers that cover x + d in the left view, the
nearest; so the nearer layers occlude, and the left-right check and the
occlusion fill have work to do. The blur is done in integers (row sums,
then column sums) and rounded as ``np.round(s / 9)`` would.
"""

import numpy as np


def layer_boxes(w, h, scene):
    """[(d, x0, x1, y0, y1)] in pixels: the background, then the layers."""
    return [(int(scene["background"]), 0, w, 0, h)] + [
        (int(d), round(x0 * w), round(x1 * w), round(y0 * h), round(y1 * h))
        for d, x0, x1, y0, y1 in scene["layers"]]


def _texture(rng, h, w):
    """(h, w, 3) uint8 band-limited noise."""
    t = rng.integers(0, 256, (h + 2, w + 2, 3), dtype=np.uint8)
    t = t.astype(np.uint16)
    s = t[0:h] + t[1:h + 1] + t[2:h + 2]
    s = s[:, 0:w] + s[:, 1:w + 1] + s[:, 2:w + 2]
    # round(s / 9), half up: s / 9 is never a whole number and a half
    return ((2 * s + 9) // 18).astype(np.uint8)


def layered_pair(rng, w, h, scene):
    """One (left, right, disparity, nonocc) scene of ``scene``'s layers at
    (w, h): uint8 views (3 channels), the left view's integer disparity,
    and the mask of left pixels that the right view sees. Layers are
    rectangles, so each is pasted as a slice: its texture spans its own
    box (the background's also the columns past the right edge that the
    right view sees)."""
    boxes = layer_boxes(w, h, scene)
    if min(b[0] for b in boxes) < 0:
        raise ValueError("layer disparities must be >= 0")
    left = np.empty((h, w, 3), np.uint8)
    right = np.empty((h, w, 3), np.uint8)
    disp = np.empty((h, w), np.int64)
    top_l = np.empty((h, w), np.intp)
    top_r = np.empty((h, w), np.intp)
    for i, (d, x0, x1, y0, y1) in enumerate(boxes):  # far to near
        tex = _texture(rng, y1 - y0, x1 - x0 + (d if i == 0 else 0))
        left[y0:y1, x0:x1] = tex[:, :x1 - x0]
        disp[y0:y1, x0:x1] = d
        top_l[y0:y1, x0:x1] = i
        # right columns x whose x + d lies in the layer (all, for the
        # background, whose texture runs on past the image)
        a, b = (0, w) if i == 0 else (max(x0 - d, 0), min(x1 - d, w))
        if b > a:
            right[y0:y1, a:b] = tex[:, a + d - x0:b + d - x0]
            top_r[y0:y1, a:b] = i
    ys, xs = np.ogrid[0:h, 0:w]
    xr = xs - disp
    nonocc = (xr >= 0) & (top_r[ys, np.clip(xr, 0, w - 1)] == top_l)
    return left, right, disp, nonocc


def pool(rng, w, h, scene, pairs, per_call):
    """``pairs`` distinct scenes cut into call inputs of ``per_call``
    pairs: [(left, right)], each (H, W, 3) for one pair a call, else the
    (per_call, H, W, 3) stacks of consecutive pairs."""
    if pairs % per_call or pairs // per_call < 2:
        raise ValueError(f"a pool of {pairs} pairs must hold two or more "
                         f"calls of {per_call}")
    made = [layered_pair(rng, w, h, scene)[:2] for _ in range(pairs)]
    if per_call == 1:
        return [(np.ascontiguousarray(left), np.ascontiguousarray(right))
                for left, right in made]
    return [(np.stack([p[0] for p in made[k:k + per_call]]),
             np.stack([p[1] for p in made[k:k + per_call]]))
            for k in range(0, pairs, per_call)]
