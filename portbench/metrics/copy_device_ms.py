"""copy_device_ms: device time a call, in ms, of the host-to-device and
device-to-host copies (the pageable upload of the pairs and the readback
of the maps)."""


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    s = t.copy_s()
    return s * 1e3 / t.calls if s > 0 else None
