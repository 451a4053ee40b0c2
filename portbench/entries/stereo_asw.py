"""Entry into the port's ASW matcher: ``StereoASW.compute`` for one pair a
call, ``StereoASW.computeBatch`` for a stack, numpy BGR in and numpy maps
out, as the port's examples 009 and 010 call it."""


def make(config, device):
    """(compute, computeBatch) of a ``StereoASW`` built from the
    configuration's ``params`` on ``device``."""
    from simplestereo_tpu_torch.passive import StereoASW
    matcher = StereoASW(**config["params"], device=device)
    return matcher.compute, matcher.computeBatch
