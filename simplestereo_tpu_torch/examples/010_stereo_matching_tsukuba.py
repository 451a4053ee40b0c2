"""ASW vs SGM vs GSW on the Tsukuba pair with ground-truth evaluation
(cf. reference examples/010, which ships the ground truth but only
visualizes; metrics here come from ss.evaluation).

Usage: 010_stereo_matching_tsukuba.py [--device DEV]
"""

import numpy as np

import simplestereo_tpu_torch as ss
from simplestereo_tpu_torch.evaluation import (evaluate_disparity,
                                               tsukuba_scale)
from simplestereo_tpu_torch.examples._cli import REFERENCE_RES, device_arg
from simplestereo_tpu_torch.imgio import imread, imwrite

DEVICE = device_arg()
RES = REFERENCE_RES + "/tsukuba/"
img1 = imread(RES + "tsukuba_l.png")
img2 = imread(RES + "tsukuba_r.png")
gt = imread(RES + "groundtruth.png", grayscale=True)
nonocc = imread(RES + "nonocc.png", grayscale=True) > 0

asw = ss.passive.StereoASW(winSize=35, minDisparity=4, maxDisparity=14,
                           gammaC=15, gammaP=17.5, consistent=True,
                           device=DEVICE)
dispASW = asw.compute(img1, img2)

sgm = ss.passive.StereoSGM(minDisparity=4, numDisparities=10, blockSize=11,
                           device=DEVICE)
dispSGM = sgm.compute(img1, img2)

# GSW at its tuned point (closed-form weights; the hand-written CUDA
# kernel on the card).
gsw = ss.passive.StereoGSW(winSize=23, minDisparity=4, maxDisparity=14,
                           gamma=12.5, fMax=20, consistent=True,
                           device=DEVICE)
dispGSW = gsw.compute(img1, img2)
gswInval = min(gsw.minDisparity - 1, -1)

# Invalid markers, derived from the matchers so parameter edits can't
# skew the metrics: consistent ASW marks minDisparity - 1 (or -1 when
# minDisparity >= 0), SGM (minDisparity - 1) * 16.
aswInval = min(asw.minDisparity - 1, -1)
for name, disp, scale, inval in (("ASW", dispASW, 1.0, aswInval),
                                 ("SGM", dispSGM, 1 / 16.0,
                                  (sgm.minDisparity - 1) * 16),
                                 ("GSW", dispGSW, 1.0, gswInval)):
    r = evaluate_disparity(disp, gt, nonocc, disp_scale=scale,
                           invalid=inval, gt_scale=tsukuba_scale)
    print(f"{name}: bad-2.0 = {r['bad2']:.2%}  avgerr = {r['avgerr']:.2f}px"
          f"  rms = {r['rms']:.2f}px  density = {r['density']:.2%}")
    d = np.asarray(disp, np.float32) * scale
    vis = (d - d.min()) / max(np.ptp(d), 1) * 255
    imwrite(f"tsukuba_{name.lower()}.png", vis.astype(np.uint8))

# Best-quality one-call preset. Defaults are the PLAIN tuned consistent
# ASW - the measured-best point on Tsukuba's integer ground truth; the
# subpixel/WLS levers are off unless asked for.
dispQ = ss.passive.quality_disparity(img1, img2, 4, 14, device=DEVICE)
r = evaluate_disparity(dispQ, gt, nonocc, gt_scale=tsukuba_scale)
print(f"quality preset (tuned consistent ASW): bad-2.0 = {r['bad2']:.2%}"
      f"  avgerr = {r['avgerr']:.2f}px  rms = {r['rms']:.2f}px"
      f"  density = {r['density']:.2%}")
visQ = (dispQ - dispQ.min()) / max(np.ptp(dispQ), 1) * 255
imwrite("tsukuba_quality.png", visQ.astype(np.uint8))
