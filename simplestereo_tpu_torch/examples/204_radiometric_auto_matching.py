"""Radiometric-aware matching: ``StereoGSW(costMethod="auto")``.

Beyond the reference (its GSW is single-cost and its MI cost is an
unimplemented TODO, _passive.cpp:506-508): the ``auto`` cost method
probes each pair's radiometric agreement with a cheap histogram
earth-mover's distance (:func:`simplestereo_tpu_torch.passive.gsw.
radiometric_divergence`) and engages the mutual-information cost only
when the squared-difference cost is actually broken - MI is slower and
slightly worse on matched radiometry, so paying its tax by default
would be wrong.

The demo matches the Tsukuba pair twice: as shipped (matched
radiometry -> picks "sd") and with a gamma-0.5 response mismatch
applied to the right image (simulating cameras with different response
curves -> picks "mi"), and reports bad-2.0 against the bundled ground
truth for both, plus what the non-adaptive SD cost would have scored
under the mismatch.

Usage: 204_radiometric_auto_matching.py [tsukuba_dir] [--device DEV]
"""

import sys

import numpy as np

import simplestereo_tpu_torch as ss
from simplestereo_tpu_torch.evaluation import (evaluate_disparity,
                                               tsukuba_scale)
from simplestereo_tpu_torch.examples._cli import REFERENCE_RES, device_arg
from simplestereo_tpu_torch.imgio import imread
from simplestereo_tpu_torch.passive.gsw import radiometric_divergence

DEVICE = device_arg()
res = (sys.argv[1] if len(sys.argv) > 1
       else REFERENCE_RES + "/tsukuba")
left = imread(f"{res}/tsukuba_l.png")
right = imread(f"{res}/tsukuba_r.png")
gt = imread(f"{res}/groundtruth.png", grayscale=True)
nonocc = imread(f"{res}/nonocc.png", grayscale=True)


def bad2(disp):
    return evaluate_disparity(disp, gt, nonocc > 0, bad_thresholds=(2.0,),
                              gt_scale=tsukuba_scale)["bad2"]


# a response-curve mismatch between the two cameras (gamma 0.5)
right_mm = np.clip(255.0 * (right / 255.0) ** 0.5, 0, 255).astype(np.uint8)

matcher = ss.passive.StereoGSW(winSize=23, minDisparity=4,
                               maxDisparity=14, gamma=12.5, fMax=20,
                               bins=24, miIterations=3, consistent=True,
                               costMethod="auto", device=DEVICE)

for tag, r in (("matched", right), ("gamma-0.5 mismatch", right_mm)):
    emd = radiometric_divergence(left, r)
    disp = matcher.compute(left, r)
    print(f"{tag}: probe EMD {emd:.1f} gray levels -> auto picked "
          f"'{matcher.lastCostMethod}', bad-2.0 "
          f"{bad2(disp) * 100:.1f} %")

# what the non-adaptive default would have cost under the mismatch
sd = ss.passive.StereoGSW(winSize=23, minDisparity=4, maxDisparity=14,
                          gamma=12.5, fMax=20, consistent=True,
                          costMethod="sd", device=DEVICE)
print(f"(fixed 'sd' under the mismatch: bad-2.0 "
      f"{bad2(sd.compute(left, right_mm)) * 100:.1f} % - the collapse "
      "'auto' avoids)")
