"""Right answers completed in the window over the window's seconds."""


def read(ctx):
    return ctx.answered / ctx.window_s
