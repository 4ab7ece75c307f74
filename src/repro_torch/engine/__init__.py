"""repro_torch.engine — the cost-based relational query engine over the
port's join / group-by operators: the port of the JAX package's `engine`.

  logical    dataclass plan IR + fluent builder (scan/filter/join/...)
  stats      table statistics & cardinality estimation (distinct sketches,
             match-ratio and zipf estimates from device-side samples) —
             synthesizes the `JoinStats` the planner consumes
  physical   optimizer: greedy join ordering on estimated cardinalities,
             Fig. 18 algorithm/pattern selection + §5.4 cost model per
             join, group-by strategy choice, group-join fusion, static
             capacity propagation; `explain()` renders the choices
  executor   eager interpreter running the physical plan over `Table`s on
             their device (the card's kernels for tables on the card)
  membudget  the device's byte budget and the memory error classifier

Typical use::

    from repro_torch.core import table_from_numpy
    from repro_torch.engine import Catalog, optimize, scan

    cat = Catalog({"fact": table_from_numpy(fact), "dim0": table_from_numpy(dim0)})
    q = (scan("fact")
         .join(scan("dim0"), left_key="fk0", right_key="k0")
         .group_by("fk0", payload="sum"))
    plan = optimize(q, cat)          # profile measured on the catalog's device
    print(plan.explain())            # per-op algorithm/pattern + cost
    result, count = plan.run()
"""
from .executor import execute, plan_peak_bytes, run, run_morsels
from .logical import Filter, GroupBy, Join, OrderByLimit, Plan, Project, Scan, output_columns, scan
from .membudget import MemoryBudget, MemoryBudgetExceeded, detect_budget_bytes, is_memory_error
from .physical import (Optimizer, PhysicalPlan, calibrated_profile, morsel_axis, morsel_plan,
                       optimize)
from .stats import (Catalog, ColumnStats, TableStats, collect_table_stats, estimate_distinct,
                    estimate_match_ratio, estimate_selectivity, estimate_zipf,
                    synthesize_join_stats)

__all__ = [
    "Plan", "Scan", "Filter", "Project", "Join", "GroupBy", "OrderByLimit",
    "scan", "output_columns",
    "Catalog", "ColumnStats", "TableStats", "collect_table_stats",
    "estimate_distinct", "estimate_match_ratio", "estimate_zipf",
    "estimate_selectivity", "synthesize_join_stats",
    "Optimizer", "PhysicalPlan", "optimize", "calibrated_profile",
    "morsel_axis", "morsel_plan",
    "execute", "run", "run_morsels", "plan_peak_bytes",
    "MemoryBudget", "MemoryBudgetExceeded", "detect_budget_bytes",
    "is_memory_error",
]
