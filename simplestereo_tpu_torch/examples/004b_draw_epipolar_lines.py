"""Draw corresponding epipolar lines on an undistorted pair
(cf. reference examples/004b).

Usage: 004b_draw_epipolar_lines.py [--device DEV]
"""

import numpy as np

import simplestereo_tpu_torch as ss
from simplestereo_tpu_torch.examples._cli import REFERENCE_RES, device_arg
from simplestereo_tpu_torch.imgio import imread, imwrite

DEVICE = device_arg()
RES = REFERENCE_RES + "/1/"
rig = ss.StereoRig.fromFile(RES + "rig.json", device=DEVICE)
img1 = imread(RES + "left.png")
img2 = imread(RES + "right.png")
img1, img2 = rig.undistortImages(img1, img2)

F = np.asarray(rig.getFundamentalMatrix())
img1, img2 = ss.utils.drawCorrespondingEpipolarLines(
    img1, img2, F, x1=[(620, 220), (640, 370)], color=(0, 0, 255))
imwrite("left_epilines.png", img1)
imwrite("right_epilines.png", img2)
print("Saved epipolar-line pair")
