"""Milliseconds of the plan's group-join nodes, each timed alone on its
children's results after the window (bench/spans.py)."""


def read(ctx):
    walls = [s["wall_s"] for s in ctx.spans or () if s["op"] == "groupjoin"]
    return sum(walls) * 1e3 if walls else None
