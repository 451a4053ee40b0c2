"""Project Gray-code patterns and capture them with the camera
(cf. reference examples/102). Pattern display needs a GUI environment;
this script only generates the pattern images.

Usage: 102_cam_proj_capture.py [--device DEV]
"""

import simplestereo_tpu_torch as ss
from simplestereo_tpu_torch.examples._cli import device_arg

device_arg()  # the patterns are made on the host
n = ss.active.generateGrayCodeImgs("graycode_patterns", (1280, 720))
print(f"Generated {n} patterns in graycode_patterns/")
