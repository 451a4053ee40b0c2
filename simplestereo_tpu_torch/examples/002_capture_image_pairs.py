"""Capture synchronized stereo pairs from two sources
(cf. reference examples/002). Sources can be camera indexes
(/dev/video*), driver objects, directories, video files or stream URLs;
frames are pulled via the threaded ss.utils.Capture grabber.

Usage: 002_capture_image_pairs.py [SRC1 SRC2] [--device DEV]
"""

import sys
import time

import simplestereo_tpu_torch as ss
from simplestereo_tpu_torch.examples._cli import device_arg
from simplestereo_tpu_torch.imgio import imwrite

device_arg()  # capture runs on the host


def wait_frame(cap, timeout=5.0):
    """First frame can lag the grab-thread start (the reference docs note
    the same for streams); poll until one lands."""
    t0 = time.time()
    while time.time() - t0 < timeout:
        f = cap.get()
        if f is not None:
            return f
        time.sleep(0.01)
    return None


SRC1, SRC2 = (sys.argv[1], sys.argv[2]) if len(sys.argv) > 2 else (0, 1)

with ss.utils.Capture(SRC1) as cap1, ss.utils.Capture(SRC2) as cap2:
    for i in range(10):
        f1 = wait_frame(cap1)
        f2 = wait_frame(cap2)
        if f1 is None or f2 is None:
            break
        imwrite(f"{i}_L.png", f1)
        imwrite(f"{i}_R.png", f2)
        print("saved pair", i)
