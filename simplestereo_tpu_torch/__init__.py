"""
simplestereo_tpu_torch
======================

PyTorch/CUDA port of :mod:`simplestereo_tpu` for one NVIDIA H100.

The JAX package stays the reference; each module here mirrors its
counterpart there (``passive/lab.py`` <- ``simplestereo_tpu/passive/lab.py``
and so on) and is tested against it on the same inputs. Functions take
tensors and run on the device those tensors live on; the matcher and rig
classes take an explicit ``device`` and raise when it is not available
(there is no silent CPU fallback). Rig algebra stays host-side in float64
numpy, as in the JAX package.

Every Pallas kernel of the JAX package becomes a hand-written CUDA kernel
for ``sm_90a`` (sources under ``csrc/``, built with ``nvcc`` at first use,
see :mod:`._build`), and so do the IIR unwrapping scan of
:mod:`.unwrapping` and the WLS smoother's line solves
(:mod:`.passive.wls`). Beside each kernel lives its plain PyTorch twin: the
CPU path, and the version the kernel is checked against on the card. Host
C++ (the PLY writer, the PNG row filters) lives under ``native/`` and is
built with ``g++`` at first use. :mod:`.parallel` tiles and batches the
matchers over several cards on ``torch.distributed``.

This package imports ``torch``, ``numpy`` and ``scipy`` and never ``jax``
or Pillow; ``matplotlib`` only when an FTP debug plot is asked for.

The import itself is timed, from this file's first statement to its
last, and kept as the set-up span ``"import"`` of
:func:`.profiling.setup_spans`.
"""

from time import perf_counter as _perf_counter

_import_start = _perf_counter()

__version__ = "0.1.0"

from .rigs import StereoRig, RectifiedStereoRig, StructuredLightRig

from . import geometry
from . import warp
from . import rigs
from . import rectification
from . import passive
from . import points
from . import utils
from . import evaluation
from . import probes
from . import imgio
from . import unwrapping
from . import active
from . import native
from . import calibration
from . import parallel
from . import videoio
from . import v4l2
from . import profiling
from ._device import resolve_device

profiling._setup_spans.append(("import", _import_start, _perf_counter()))
del _perf_counter, _import_start

__all__ = [
    "StereoRig",
    "RectifiedStereoRig",
    "StructuredLightRig",
    "geometry",
    "warp",
    "rigs",
    "rectification",
    "passive",
    "points",
    "utils",
    "evaluation",
    "probes",
    "imgio",
    "unwrapping",
    "active",
    "native",
    "calibration",
    "parallel",
    "videoio",
    "v4l2",
    "profiling",
    "resolve_device",
]
