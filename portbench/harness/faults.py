"""Faults of the timed path, planted in the port's matcher class, that a
run's check has to catch (``correct`` false): the readings tool reads
them on the card, and the CPU tests drive whole runs with them.

Each wrapper takes the class's method and returns a broken one; numpy in,
numpy out, as the entries call them.
"""

import numpy as np


def stale(method):
    """Each call returns the previous call's maps: a step that leaves its
    state unchanged."""
    last = {}

    def call(self, a, b, *args, **kw):
        out = last.get("out")
        last["out"] = method(self, a, b, *args, **kw)
        return last["out"] if out is None else out
    return call


def half_batch(method):
    """A stack's second half is left out; its maps are the mean of the
    first half's."""
    def call(self, a, b, *args, **kw):
        n = max(len(a) // 2, 1)
        out = method(self, a[:n], b[:n], *args, **kw)
        mean = np.rint(out.mean(0)).astype(out.dtype)
        return np.concatenate([out, np.repeat(mean[None], len(a) - n, 0)])
    return call


def altered(method):
    """One row of each map, the middle one, is off by one unit where it
    is produced."""
    def call(self, a, b, *args, **kw):
        out = np.array(method(self, a, b, *args, **kw))
        out[..., out.shape[-2] // 2, :] += 1
        return out
    return call


# fault name -> (wrapper, the methods it breaks, stacks only)
FAULTS = {"stale": (stale, ("compute", "computeBatch"), False),
          "half_batch": (half_batch, ("computeBatch",), True),
          "altered": (altered, ("compute", "computeBatch"), False)}


def plant(cell, name):
    """Break the port's matcher class of ``cell`` with fault ``name``;
    returns a function that mends it, or None where the fault does not
    apply to the cell."""
    wrap, methods, stacks_only = FAULTS[name]
    if stacks_only and cell.pairs_per_call == 1:
        return None
    import simplestereo_tpu_torch.passive as passive
    cls = {"stereo_asw": passive.StereoASW,
           "stereo_sgm": passive.StereoSGM}[cell.config["entry"]]
    saved = {m: getattr(cls, m) for m in methods}
    for m, f in saved.items():
        setattr(cls, m, wrap(f))
    return lambda: [setattr(cls, m, f) for m, f in saved.items()]
