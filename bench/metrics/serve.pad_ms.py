"""Device milliseconds a query inside the server's `qserve.pad` spans in
the window: padding every table of the request to its capacity bucket
(bench/progspans.py)."""
from bench import progspans


def read(ctx):
    return progspans.device_ms_per_query(ctx, "qserve.pad")
