"""call_ms_p95: the 95th percentile (linear between order statistics) of
the host-clock latency of every call in the window, from the call to the
numpy maps in hand, in ms."""

import statistics


def read(ctx):
    lat = ctx.window.latencies_s
    if len(lat) < 2:
        return lat[0] * 1e3 if lat else None
    return statistics.quantiles(lat, n=20, method="inclusive")[-1] * 1e3
