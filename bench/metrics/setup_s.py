"""Seconds from the process's start to the window's: imports, the kernel
libraries' load (their build, in a run that builds), the tables drawn on
the card, planning and the warm-up queries."""


def read(ctx):
    return ctx.setup_s
