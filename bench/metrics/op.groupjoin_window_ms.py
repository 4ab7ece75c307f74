"""Self device milliseconds a query of the plan's group-join nodes in the
window (`exec.groupjoin` spans less their inputs' spans), as the queries
ran back to back (bench/progspans.py)."""
from bench import progspans


def read(ctx):
    return progspans.device_ms_per_query(ctx, "exec.groupjoin", own=True)
