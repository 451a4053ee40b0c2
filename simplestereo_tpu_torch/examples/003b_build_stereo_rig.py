"""Stereo chessboard calibration -> rig.json (cf. reference examples/003b).

Usage: 003b_build_stereo_rig.py [folder] [--device DEV]
"""

import glob
import sys

import simplestereo_tpu_torch as ss
from simplestereo_tpu_torch.examples._cli import REFERENCE_RES, device_arg

DEVICE = device_arg()
folder = sys.argv[1] if len(sys.argv) > 1 else \
    REFERENCE_RES + "/1/calib"
lefts = sorted(glob.glob(folder + "/*_L.png"))
rights = sorted(glob.glob(folder + "/*_R.png"))

rig = ss.calibration.chessboardStereo(
    list(zip(lefts, rights)), chessboardSize=(7, 6), squareSize=60.5,
    device=DEVICE)
print("Reprojection error:", rig.reprojectionError)
rig.save("rig.json")
print("Saved rig.json")
