"""
active
======

Active/structured-light stereo: pattern generation, Gray-code scanning,
Fourier Transform Profilometry. The port of
:mod:`simplestereo_tpu.active`, with the same exports.
"""

from .patterns import (
    generateGrayCodeImgs,
    graycode_patterns,
    graycode_num_bits,
    buildFringe,
    buildBinaryFringe,
    buildAnaglyphFringe,
    _getCentralPeak,
)
from .stripe import findCentralStripe, computeROI
from .graycode import (
    GrayCode,
    GrayCodeSingle,
    GrayCodeDouble,
    decode_graycode,
)
from .ftp import (
    StereoFTP,
    StereoFTPAnaglyph,
    StereoFTP_Mapping,
    StereoFTP_PhaseOnly,
)

__all__ = [
    "generateGrayCodeImgs",
    "graycode_patterns",
    "graycode_num_bits",
    "buildFringe",
    "buildBinaryFringe",
    "buildAnaglyphFringe",
    "findCentralStripe",
    "computeROI",
    "GrayCode",
    "GrayCodeSingle",
    "GrayCodeDouble",
    "decode_graycode",
    "StereoFTP",
    "StereoFTPAnaglyph",
    "StereoFTP_Mapping",
    "StereoFTP_PhaseOnly",
]
