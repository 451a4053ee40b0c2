"""Batched structured-light scanning: a capture stack -> clouds at once.

Beyond the reference (active.py:608-841 processes strictly ONE frame per
``getCloud`` call): :meth:`StereoFTP.getCloudBatch` runs the dense work
of a whole (B, H, W, 3) capture stack batched on the device, so the
per-frame dispatch cost is paid once per batch. ``out_dtype=np.float16``
additionally halves the cloud readback by casting on the device.

The scene is synthetic: B fronto-parallel planes at stepped depths,
rendered by projecting the fringe through the rig's own geometry (the
same construction as the test suite's ftp_scene and example 103).

Usage: 203_batch_scanning.py [batch] [width] [height] [--device DEV]
"""

import sys

import numpy as np
import torch

import simplestereo_tpu_torch as ss
from simplestereo_tpu_torch import warp
from simplestereo_tpu_torch.examples._cli import device_arg
from simplestereo_tpu_torch.geometry.npgeom import rodrigues_to_matrix

DEVICE = device_arg()
B = int(sys.argv[1]) if len(sys.argv) > 1 else 4
W = int(sys.argv[2]) if len(sys.argv) > 2 else 160
H = int(sys.argv[3]) if len(sys.argv) > 3 else 120

# Camera-projector rig (projector modeled as the second "camera").
res = (W, H)
f = 1.09 * W
K = np.array([[f, 0, (W - 1) / 2], [0, f, (H - 1) / 2], [0, 0, 1]])
R = rodrigues_to_matrix(np.array([0.0, -0.05, 0.0]))
T = np.array([[-0.31 * W], [0.008 * W], [0.047 * W]])
rig = ss.StereoRig(res, res, K, K, None, None, R, T, device=DEVICE)

period = 16.0
fringe = ss.active.buildFringe(period, dims=res, stripeColor="red")
ftp = ss.active.StereoFTP(rig, fringe, period, device=DEVICE)

# Render the capture stack: plane i sits at depth z0 * (1 + 0.02 i).
z0 = 4.06 * W
gx, gy = np.meshgrid(np.arange(W, dtype=float), np.arange(H, dtype=float))
rays = np.stack([gx, gy, np.ones_like(gx)], -1) @ np.linalg.inv(K).T
depths = z0 * (1.0 + 0.02 * np.arange(B))
fringe_t = torch.tensor(fringe, device=DEVICE)
caps = []
for z in depths:
    q = (z * rays @ R.T + T.ravel()) @ K.T
    caps.append(warp.remap(
        fringe_t,
        torch.tensor(q[..., 0] / q[..., 2], dtype=torch.float32,
                     device=DEVICE),
        torch.tensor(q[..., 1] / q[..., 2], dtype=torch.float32,
                     device=DEVICE),
        interpolation="linear").cpu().numpy())
stack = np.stack(caps)

clouds = ftp.getCloudBatch(stack, out_dtype=np.float16)
assert clouds.shape == (B, H, W, 3)

for i, (cloud, z) in enumerate(zip(clouds, depths)):
    cz = cloud[H // 4: -H // 4, W // 4: -W // 4, 2].astype(np.float64)
    cz = cz[np.isfinite(cz)]
    err = abs(float(np.median(cz)) - z) / z * 100
    print(f"frame {i}: plane z = {z:7.1f}, "
          f"median recovered z = {float(np.median(cz)):7.1f} "
          f"({err:.2f} % off)")

ss.points.exportPLY(np.asarray(clouds[0], np.float64), "scan_batch0.ply")
print(f"Saved scan_batch0.ply ({B}-frame stack, batched on the device)")
