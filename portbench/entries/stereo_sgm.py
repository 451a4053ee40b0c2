"""Entry into the port's SGM matcher: ``StereoSGM.compute`` for one pair a
call, ``StereoSGM.computeBatch`` for a stack, numpy BGR in and numpy maps
(disparity x 16, int16) out, as the port's example 008 calls it."""


def make(config, device):
    """(compute, computeBatch) of a ``StereoSGM`` built from the
    configuration's ``params`` on ``device``."""
    from simplestereo_tpu_torch.passive import StereoSGM
    matcher = StereoSGM(**config["params"], device=device)
    return matcher.compute, matcher.computeBatch
