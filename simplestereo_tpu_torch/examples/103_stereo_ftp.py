"""Fourier Transform Profilometry scan -> point cloud
(cf. reference examples/103). The object image of the reference's dataset
is not committed upstream; pass your capture as argv[1], or let the
script synthesize one by projecting the fringe onto a fronto-parallel
plane through the rig's own geometry (same construction as the test
suite's ftp_scene).

Usage: 103_stereo_ftp.py [object_image] [--device DEV]
"""

import os
import sys

import numpy as np

import simplestereo_tpu_torch as ss
from simplestereo_tpu_torch.examples._cli import REFERENCE_RES, device_arg
from simplestereo_tpu_torch.imgio import imread

DEVICE = device_arg()
RES = REFERENCE_RES + "/stereoFTP/"
OBJ_IMAGE = sys.argv[1] if len(sys.argv) > 1 else RES + "ellipsoid8.png"

rig = ss.StereoRig.fromFile(RES + "stereoRig.json", device=DEVICE)
fringe = imread(RES + "fringe8.png")
ftp = ss.active.StereoFTP(rig, fringe, period=8, device=DEVICE)

if os.path.exists(OBJ_IMAGE):
    imgObj = imread(OBJ_IMAGE)
else:
    print(f"{OBJ_IMAGE} not found (not committed upstream); "
          "synthesizing a plane capture")
    import torch
    from simplestereo_tpu_torch import warp

    K1 = np.asarray(rig.intrinsic1, float)
    K2 = np.asarray(rig.intrinsic2, float)
    R = np.asarray(rig.R, float)
    T = np.asarray(rig.T, float).ravel()
    w, h = rig.res1
    xs, ys = np.meshgrid(np.arange(w, dtype=float),
                         np.arange(h, dtype=float))
    rays = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(K1).T
    z0 = 1500.0
    P = z0 * rays
    q = (P @ R.T + T) @ K2.T
    mapu = torch.tensor((q[..., 0] / q[..., 2]).astype(np.float32),
                        device=DEVICE)
    mapv = torch.tensor((q[..., 1] / q[..., 2]).astype(np.float32),
                        device=DEVICE)
    imgObj = warp.remap(torch.tensor(fringe, device=DEVICE), mapu, mapv,
                        interpolation="linear").cpu().numpy()
    # real captures carry ambient light; the pure sinusoid touches 0,
    # which would erode computeROI's black-threshold box to nothing
    lit = warp.remap(
        torch.full(fringe.shape[:2], 255, dtype=torch.uint8, device=DEVICE),
        mapu, mapv).cpu().numpy() > 0
    imgObj = np.where(lit[..., None],
                      np.clip(0.85 * imgObj + 24, 0, 255), 0
                      ).astype(np.uint8)

roi = ss.active.computeROI(imgObj, blackThreshold=10)
cloud = ftp.getCloud(imgObj, roi=roi)

ss.points.exportPLY(np.asarray(cloud), "scan.ply")
print("Saved scan.ply")
