"""Launches of the port's kernels in the window (the program's
`ops.launch_counts()`) per query answered."""


def read(ctx):
    if ctx.launches is None or not ctx.completed:
        return None
    return sum(ctx.launches.values()) / ctx.completed
