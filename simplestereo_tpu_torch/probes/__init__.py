"""
probes
======

Hardware probes of the port: :mod:`.rotate` is kernel K4, the per-plane
dynamic roll that ASW's consistent mode rests on.
"""

from . import rotate

__all__ = ["rotate"]
