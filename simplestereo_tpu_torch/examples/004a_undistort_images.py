"""Undistort a stereo pair with the calibrated rig
(cf. reference examples/004a).

Usage: 004a_undistort_images.py [--device DEV]
"""

import simplestereo_tpu_torch as ss
from simplestereo_tpu_torch.examples._cli import REFERENCE_RES, device_arg
from simplestereo_tpu_torch.imgio import imread, imwrite

DEVICE = device_arg()
RES = REFERENCE_RES + "/1/"
rig = ss.StereoRig.fromFile(RES + "rig.json", device=DEVICE)
img1 = imread(RES + "left.png")
img2 = imread(RES + "right.png")

u1, u2 = rig.undistortImages(img1, img2)
imwrite("left_undist.png", u1)
imwrite("right_undist.png", u2)
print("Saved undistorted pair")
