"""Per-node spans of the window's own plan on its own inputs, taken after
the window closes: each node runs alone on its children's materialized
results and is timed by the port's `obs.trace.timed_call` (CUDA events on
the card). The program's traced run (`run(trace=True)`) takes no valid
counts, so the served cells' padded tables could not go through it; this
walk hands the scans the counts the server hands them."""
from __future__ import annotations

import dataclasses


def node_spans(plan, tables, counts=None, *, iters: int = 3, warmup: int = 1) -> list[dict]:
    """One dict per plan node, children first: op, strategy, the node's
    median seconds alone, its valid output rows and its capacity."""
    from repro_torch.engine import executor
    from repro_torch.obs.trace import op_of, strategy_of, timed_call

    device = next(iter(tables.values())).device
    spans: list[dict] = []

    def visit(node):
        kids = [visit(k) for k in node.children()]
        if kids:
            mats = [executor.Materialized(v) for v in kids]
            alone = (dataclasses.replace(node, child=mats[0]) if len(mats) == 1
                     else dataclasses.replace(node, build=mats[0], probe=mats[1]))

            def fn():
                return executor.execute(alone, {})
        else:
            def fn():
                return executor.execute(node, tables, counts)
        (out, count), wall = timed_call(fn, iters=iters, warmup=warmup, device=device)
        spans.append({"op": op_of(node), "strategy": strategy_of(node), "wall_s": wall,
                      "rows_out": int(count), "capacity": int(node.capacity)})
        return out, count

    visit(plan.root)
    return spans
