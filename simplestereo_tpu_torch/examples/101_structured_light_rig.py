"""Triangulate known camera-projector correspondences with a
StructuredLightRig (cf. reference examples/101).

Usage: 101_structured_light_rig.py [--device DEV]
"""

import numpy as np

import simplestereo_tpu_torch as ss
from simplestereo_tpu_torch.examples._cli import REFERENCE_RES, device_arg

DEVICE = device_arg()
RES = REFERENCE_RES + "/stereoFTP/"
rig = ss.StructuredLightRig.fromFile(RES + "stereoRig.json", device=DEVICE)

camPoints = np.array([[320.5, 240.5], [400.0, 300.0]])
projPoints = np.array([[640.0, 360.0], [700.0, 420.0]])
world = rig.triangulate(camPoints, projPoints)
print("Triangulated points:\n", world.reshape(-1, 3))
