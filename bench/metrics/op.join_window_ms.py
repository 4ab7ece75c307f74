"""Self device milliseconds a query of the plan's join nodes in the window
(`exec.join` spans less their inputs' spans), as the queries ran back to
back (bench/progspans.py)."""
from bench import progspans


def read(ctx):
    return progspans.device_ms_per_query(ctx, "exec.join", own=True)
