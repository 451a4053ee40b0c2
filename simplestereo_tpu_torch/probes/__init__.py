"""
probes
======

Hardware probes of the port: :mod:`.rotate` is kernel K4, the per-plane
dynamic roll that ASW's consistent mode rests on. ``iir_variants`` (run
as ``python3 -m simplestereo_tpu_torch.probes.iir_variants`` on a card)
times edited copies of kernel S1 to show where its time goes.
"""

from . import rotate

__all__ = ["rotate"]
