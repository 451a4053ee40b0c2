"""The matchers' numpy entry: a pair or a stack up to the device, the
match there, the maps back, each step a span."""

import torch

from ..profiling import annotate


def run_numpy(fn, imgs1, imgs2, device, **kwargs):
    """``fn(t1, t2, **kwargs)`` on numpy ``imgs1``, ``imgs2`` uploaded to
    ``device``, its result read back as numpy. Spans: ``upload``, ``match`` (the
    launches; the device may still be running when it ends) and
    ``readback`` (waits for the device's maps, then copies them)."""
    with annotate("upload"):
        t1 = torch.tensor(imgs1, device=device)
        t2 = torch.tensor(imgs2, device=device)
    with annotate("match"):
        out = fn(t1, t2, **kwargs)
    with annotate("readback"):
        return out.cpu().numpy()
