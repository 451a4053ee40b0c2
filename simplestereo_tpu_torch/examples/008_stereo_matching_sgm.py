"""Dense disparity with the built-in SGM matcher (its path aggregation on
the hand-written CUDA kernel) - the replacement for the reference's
cv2.StereoSGBM call (examples/008).

Usage: 008_stereo_matching_sgm.py [DOWN] [--device DEV]
"""

import sys

import numpy as np

import simplestereo_tpu_torch as ss
from simplestereo_tpu_torch.examples._cli import REFERENCE_RES, device_arg
from simplestereo_tpu_torch.imgio import imread, imwrite

DEVICE = device_arg()
# Optional integer downscale (the knob the reference example applies
# unconditionally, examples/008:24-27); 1 = full resolution.
DOWN = int(sys.argv[1]) if len(sys.argv) > 1 else 1

RES = REFERENCE_RES + "/2/"
rigRect = ss.RectifiedStereoRig.fromFile(RES + "rigRect.json", device=DEVICE)
img1, img2 = rigRect.rectifyImages(
    imread(RES + "lawn_L.png"), imread(RES + "lawn_R.png"))
img1, img2 = img1[::DOWN, ::DOWN], img2[::DOWN, ::DOWN]

# costMethod="census" (Hamming on census codes) is invariant to
# radiometric differences between the two cameras; "bt" (default)
# mirrors OpenCV's Birchfield-Tomasi-on-Sobel. Retune P1/P2 per cost.
stereo = ss.passive.StereoSGM(minDisparity=1, numDisparities=96 // DOWN,
                              blockSize=3, costMethod="census",
                              censusWindow=7, P1=120, P2=480, device=DEVICE)
raw = stereo.compute(img1, img2)
# cv2.medianBlur counterpart: knocks down speckle before use.
disparity = ss.passive.median_disparity(
    raw, 3, device=DEVICE).astype(np.float32) / 16

vis = (disparity - disparity.min()) / max(np.ptp(disparity), 1) * 255
imwrite("disparity_sgm.png", vis.astype(np.uint8))
print("Saved disparity_sgm.png")
