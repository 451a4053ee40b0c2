"""Streaming stereo depth service: Capture -> batched matching on the card.

Production-serving shape on one card: frames are pulled from two
(synthetic or live) cameras by the threaded grabbers, accumulated into
fixed-size batches, and matched with ONE kernel launch per batch
(`StereoASW.computeBatch` - the frame axis rides the kernel's grid, so
the per-launch cost is amortized; see simplestereo_tpu_torch/passive).

Swap the `make_camera` callables for `ss.utils.Capture(0)` /
`Capture(1)` (V4L2), a video file, an MJPEG stream URL or any
driver-protocol object to run live.

Usage: 202_streaming_pipeline.py [n_batches] [batch_size] [--device DEV]
"""

import sys
import time

import numpy as np

import simplestereo_tpu_torch as ss
from simplestereo_tpu_torch.examples._cli import device_arg

DEVICE = device_arg()
N_BATCHES = int(sys.argv[1]) if len(sys.argv) > 1 else 3
BATCH = int(sys.argv[2]) if len(sys.argv) > 2 else 4
H, W = 96, 128


def make_camera(shift):
    """Synthetic camera viewing a static scene from a shifted viewpoint.

    (The two Captures' grab threads are free-running, so a time-varying
    scene would de-synchronize the pair - real rigs hardware-trigger
    both sensors; a static scene keeps this demo's correspondence exact.)
    """
    rng = np.random.default_rng(0)
    base = rng.integers(0, 256, (H, W + 32, 3), np.uint8)

    def read():
        return np.ascontiguousarray(base[:, shift: shift + W])

    return read


def wait_frame(cap, timeout=5.0):
    t0 = time.time()
    while time.time() - t0 < timeout:
        f = cap.get()
        if f is not None:
            return f
        time.sleep(0.002)
    raise RuntimeError("camera produced no frame")


matcher = ss.passive.StereoASW(winSize=9, maxDisparity=8, consistent=True,
                               device=DEVICE)

# left(x) = right(x - d) with d = shiftR - shiftL = 4
with ss.utils.Capture(make_camera(0)) as capL, \
        ss.utils.Capture(make_camera(4)) as capR:
    for b in range(N_BATCHES):
        lefts, rights = [], []
        while len(lefts) < BATCH:
            lefts.append(wait_frame(capL))
            rights.append(wait_frame(capR))
        t0 = time.perf_counter()
        disp = matcher.computeBatch(np.stack(lefts), np.stack(rights))
        dt = time.perf_counter() - t0
        frac4 = (disp == 4).mean()
        print(f"batch {b}: {BATCH} frames in {dt*1e3:.1f} ms "
              f"({dt/BATCH*1e3:.1f} ms/frame), "
              f"disparity==4 on {frac4:.0%} of pixels")
        assert frac4 > 0.8, "matching broke"

print("done")
