"""Explicit device selection: no silent fallback from CUDA to the CPU."""

import torch


def resolve_device(device):
    """Return ``device`` as a :class:`torch.device`.

    Raises ``RuntimeError`` for a CUDA device when PyTorch sees no card:
    asking for the card and silently running on the CPU would hide which
    device did the work.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False")
    return dev
