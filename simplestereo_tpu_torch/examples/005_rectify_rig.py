"""Rectify a calibrated rig analytically (cf. reference examples/005:
directRectify is the default minimal-distortion method).

Usage: 005_rectify_rig.py [--device DEV]
"""

import simplestereo_tpu_torch as ss
from simplestereo_tpu_torch.examples._cli import REFERENCE_RES, device_arg

DEVICE = device_arg()
RES = REFERENCE_RES + "/2/"
rig = ss.StereoRig.fromFile(RES + "rig.json", device=DEVICE)

rigRect = ss.rectification.directRectify(rig)
# Alternatives: ss.rectification.fusielloRectify(rig),
#               ss.rectification.loopRectify(rig),
#               ss.rectification.stereoRectify(rig)
rigRect.save("rigRect.json")
print("Saved rigRect.json")
