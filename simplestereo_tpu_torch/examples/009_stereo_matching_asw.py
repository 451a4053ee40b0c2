"""Dense disparity with the adaptive-support-weight matcher on its
hand-written CUDA kernel (cf. reference examples/009; unlike the
reference's C++ version, no pre-downscaling is needed on the card).

Usage: 009_stereo_matching_asw.py [DOWN] [--device DEV]
"""

import sys

import numpy as np

import simplestereo_tpu_torch as ss
from simplestereo_tpu_torch.examples._cli import REFERENCE_RES, device_arg
from simplestereo_tpu_torch.imgio import imread, imwrite

DEVICE = device_arg()
# Optional integer downscale (the reference example always downscales 4x,
# examples/009:31-34; on the card the full-resolution scan is practical).
DOWN = int(sys.argv[1]) if len(sys.argv) > 1 else 1

RES = REFERENCE_RES + "/2/"
rigRect = ss.RectifiedStereoRig.fromFile(RES + "rigRect.json", device=DEVICE)
img1, img2 = rigRect.rectifyImages(
    imread(RES + "lawn_L.png"), imread(RES + "lawn_R.png"))
img1, img2 = img1[::DOWN, ::DOWN], img2[::DOWN, ::DOWN]

# step=2 = subsampled window scan (the speedup the reference suggested at
# passive.py:43-46 but never built): about half the work of step 1 with
# no visible quality change. The reference instead downscales the pair 4x
# before matching ("EXTREMELY SLOW", examples/009:29-33).
stereo = ss.passive.StereoASW(winSize=35, maxDisparity=max(90 // DOWN, 2),
                              minDisparity=1, gammaC=15, gammaP=17.5,
                              consistent=True, step=2, device=DEVICE)
disparity = stereo.compute(img1, img2)

vis = (disparity - disparity.min()) / max(np.ptp(disparity), 1) * 255
imwrite("disparity_asw.png", vis.astype(np.uint8))
print("Saved disparity_asw.png")
