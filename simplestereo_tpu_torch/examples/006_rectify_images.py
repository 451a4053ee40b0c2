"""Apply rectification maps to an image pair (cf. reference examples/006).
The warp runs on the device (a gather remap).

Usage: 006_rectify_images.py [--device DEV]
"""

import simplestereo_tpu_torch as ss
from simplestereo_tpu_torch.examples._cli import REFERENCE_RES, device_arg
from simplestereo_tpu_torch.imgio import imread, imwrite

DEVICE = device_arg()
RES = REFERENCE_RES + "/2/"
rigRect = ss.RectifiedStereoRig.fromFile(RES + "rigRect.json", device=DEVICE)
img1 = imread(RES + "lawn_L.png")
img2 = imread(RES + "lawn_R.png")

r1, r2 = rigRect.rectifyImages(img1, img2)
imwrite("lawn_L_rect.png", r1)
imwrite("lawn_R_rect.png", r2)
print("Saved rectified pair")
