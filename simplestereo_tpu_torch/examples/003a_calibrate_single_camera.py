"""Single-camera chessboard calibration (cf. reference examples/003a).

Usage: 003a_calibrate_single_camera.py [folder] [--device DEV]
"""

import glob
import sys

import simplestereo_tpu_torch as ss
from simplestereo_tpu_torch.examples._cli import REFERENCE_RES, device_arg

DEVICE = device_arg()
folder = sys.argv[1] if len(sys.argv) > 1 else \
    REFERENCE_RES + "/1/calib"
images = sorted(glob.glob(folder + "/*_L.png"))

rms, K, dist, rvecs, tvecs = ss.calibration.chessboardSingle(
    images, chessboardSize=(7, 6), squareSize=60.5, device=DEVICE)
print("RMS reprojection error:", rms)
print("Camera matrix:\n", K)
print("Distortion coefficients:", dist)
