"""The group node's static capacity (the plan's) over the groups it
produced (its span's valid rows): how far the plan's sizing overshoots.
The group node is the group-join or group-by nearest the plan's root."""


def read(ctx):
    groups = [s for s in ctx.spans or () if s["op"] in ("groupjoin", "groupby")]
    if not groups or not groups[-1]["rows_out"]:
        return None
    return groups[-1]["capacity"] / groups[-1]["rows_out"]
