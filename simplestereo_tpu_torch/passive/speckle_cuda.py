"""
speckle_cuda
============

The speckle filter on the card: the wrapper :func:`filter_speckles` of the
hand-written CUDA kernels in ``csrc/speckle_kernel.cu``. Its twin is the
host function :func:`.sgm.filter_speckles` (numpy and scipy, the JAX
package's copy), which it equals bit for bit: the 4-connected components
of equal ``floor(d / max(max_diff, 1))``, and each component of fewer than
``max_speckle_size`` pixels set to ``new_val``.

:meth:`.sgm.StereoSGM._speckles` chooses, by what it is given: a CUDA map
takes these kernels, a numpy or CPU map the host function. There is no
TPU kernel behind this one: the JAX package filters on the host.
"""

import ctypes
import math

import torch

from .. import _build

_P, _I = ctypes.c_void_p, ctypes.c_int
LIBRARY = _build.Library("speckle_kernel", {
    # disp, out, label, count, B, H, W, m, size, new_val, device, stream
    "speckle_filter": ([_P] * 4 + [_I] * 7 + [_P], _I),
    "speckle_error_string": ([_I], ctypes.c_char_p),
})

# Calls of filter_speckles (each launches the four kernels, or four a piece
# of 65,535 frames). Lets a caller prove that a run filtered on the card.
speckle_launches = 0

INT16 = (-2**15, 2**15 - 1)


def filter_speckles(disp, new_val, max_speckle_size, max_diff):
    """The speckle-filtered copy of ``disp``, a (..., H, W) int16 CUDA
    tensor of disparity maps (each (H, W) map filtered alone), as
    ``sgm.filter_speckles`` gives it for each map.

    Launches the kernels and adds one to ``speckle_launches``. Raises
    ValueError for a map off the card, of another dtype or shape, or a
    ``new_val`` outside int16.
    """
    global speckle_launches
    if disp.dim() < 2 or disp.numel() == 0 or disp.dtype != torch.int16:
        raise ValueError(f"disp must be a non-empty (..., H, W) int16 "
                         f"tensor, got {disp.dtype} {tuple(disp.shape)}")
    dev = disp.device
    if dev.type != "cuda":
        raise ValueError(f"the speckle kernels take a CUDA tensor, got {dev}")
    if not INT16[0] <= int(new_val) <= INT16[1]:
        raise ValueError(f"new_val must fit int16, got {new_val}")
    lead, (H, W) = disp.shape[:-2], disp.shape[-2:]
    if H * W >= 2**31:
        raise ValueError(f"a map must hold fewer than 2**31 pixels, got "
                         f"{H}x{W}")
    B = math.prod(lead)
    d = disp.reshape(B, H, W).contiguous()
    out = torch.empty_like(d)
    label = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    count = torch.empty((B, H, W), dtype=torch.int32, device=dev)
    # q = floor(d / m) is -1 or 0 for every int16 once m > 2**15
    m = min(max(int(max_diff), 1), 2**16)
    # a count is a whole number of at most H * W pixels
    size = min(max(math.ceil(max_speckle_size), 0), H * W + 1)
    frame = H * W
    for b0, b1 in _build.frame_pieces(B, _build.GRID_YZ_MAX):
        LIBRARY.launch(
            "speckle_filter", dev,
            d.data_ptr() + b0 * frame * 2, out.data_ptr() + b0 * frame * 2,
            label.data_ptr() + b0 * frame * 4,
            count.data_ptr() + b0 * frame * 4, b1 - b0, H, W, m, size,
            int(new_val), what="speckle kernel launch failed")
    speckle_launches += 1
    return out.reshape(disp.shape)
