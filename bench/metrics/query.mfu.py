"""The whole query's share of the chip's peak: the query's compulsory bytes
(each column it reads, once, and its answer; bench/roofline.py) over the
HBM bandwidth, over the window's seconds per answered query, in percent.
A bound that still holds when a later change takes a kernel off the path."""
from bench import roofline


def read(ctx):
    if not ctx.completed or not ctx.compulsory_bytes:
        return None
    return 100 * roofline.bound_s(ctx.compulsory_bytes) / (ctx.window_s / ctx.completed)
