"""Generate a printable chessboard SVG (cf. reference examples/001).

Usage: 001_calibration_chessboard.py [--device DEV]
"""

import simplestereo_tpu_torch as ss
from simplestereo_tpu_torch.examples._cli import device_arg

device_arg()  # nothing here runs on a device
ss.calibration.generateChessboardSVG((7, 6), "chessboard.svg", squareSize=60)
print("Written chessboard.svg")
