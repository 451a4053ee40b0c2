"""setup_s: seconds from the process's start to the window's first call:
imports, the card's context, the scenes, the matcher, the warm calls (the
first of which loads the cell's kernel, and builds it in a fresh
checkout)."""


def read(ctx):
    return ctx.window.setup_s
