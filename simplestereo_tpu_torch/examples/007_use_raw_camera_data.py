"""Build a rig from raw parameters without calibration files
(cf. reference examples/007).

Usage: 007_use_raw_camera_data.py [--device DEV]
"""

import numpy as np

import simplestereo_tpu_torch as ss
from simplestereo_tpu_torch.examples._cli import device_arg

DEVICE = device_arg()
res = (640, 480)
K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]])
R = np.eye(3)
T = np.array([[-60.0], [0.0], [0.0]])

rig = ss.StereoRig(res, res, K, K, None, None, R, T, device=DEVICE)
rigRect = ss.rectification.fusielloRectify(rig)
print("Baseline:", rig.getBaseline())
print("Rectified projection matrices:")
P1, P2 = rigRect.getRectifiedProjectionMatrices()
print(P1)
print(P2)
