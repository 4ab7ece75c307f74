"""Milliseconds of the plan's join nodes together, each timed alone on its
children's results after the window (bench/spans.py)."""


def read(ctx):
    walls = [s["wall_s"] for s in ctx.spans or () if s["op"] == "join"]
    return sum(walls) * 1e3 if walls else None
