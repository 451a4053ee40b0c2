"""WebP, read as Pillow reads it (``WebPImagePlugin``, through libwebp's
animation decoder): the first frame on an RGBA canvas of transparent
black, mode ``RGBA`` when the file says it has alpha (a ``VP8X`` alpha
flag, or a lossless image's alpha bit), else ``RGB``. The decoding, VP8L
(lossless), VP8 (lossy) and ``ALPH``, is :func:`..native.webp_decode`.
"""

import numpy as np

from .. import native


def decode(data):
    rgba, alpha = native.webp_decode(data)
    if alpha:
        return rgba, "RGBA", None
    return np.ascontiguousarray(rgba[:, :, :3]), "RGB", None
