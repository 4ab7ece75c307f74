"""Self device milliseconds a query of the plan's group-by nodes in the
window (`exec.groupby` spans less their inputs' spans), as the queries ran
back to back (bench/progspans.py)."""
from bench import progspans


def read(ctx):
    return progspans.device_ms_per_query(ctx, "exec.groupby", own=True)
