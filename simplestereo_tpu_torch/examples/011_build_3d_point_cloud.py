"""Full pipeline: rectify -> SGM disparity -> Q reprojection -> PLY
(cf. reference examples/011).

Usage: 011_build_3d_point_cloud.py [--device DEV]
"""

import numpy as np

import simplestereo_tpu_torch as ss
from simplestereo_tpu_torch.examples._cli import REFERENCE_RES, device_arg
from simplestereo_tpu_torch.imgio import imread

DEVICE = device_arg()
RES = REFERENCE_RES + "/2/"
rigRect = ss.RectifiedStereoRig.fromFile(RES + "rigRect.json", device=DEVICE)
img1, img2 = rigRect.rectifyImages(
    imread(RES + "lawn_L.png"), imread(RES + "lawn_R.png"))

stereo = ss.passive.StereoSGM(minDisparity=1, numDisparities=96,
                              blockSize=7, speckleWindowSize=120,
                              disp12MaxDiff=1, device=DEVICE)
raw16 = stereo.compute(img1, img2)
# Production post-pass: confidence-weighted WLS fills the LR-checked
# invalids and smooths within guide-image regions before reprojection.
invalid = (stereo.minDisparity - 1) * 16   # SGM's x16 invalid marker
disparity = ss.passive.wls_filter_disparity(
    raw16, np.asarray(img1).mean(-1), lambda_=2.0, sigma_color=8.0,
    invalid=invalid, disp_scale=1 / 16.0, device=DEVICE)

points3D = rigRect.get3DPoints(disparity)
ss.points.exportPLY(np.asarray(points3D), "lawn.ply", referenceImage=img1)
print("Saved lawn.ply")
