"""results_per_s: disparity maps returned over the whole window, divided by
the window's seconds (host clock); a call of a stack of B pairs returns B
maps. A call that raised returns none."""


def read(ctx):
    w = ctx.window
    return w.results / w.window_s if w.window_s > 0 else None
