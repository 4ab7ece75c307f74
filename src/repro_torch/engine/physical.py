"""Physical planner: logical plan + estimated statistics -> executable plan.
The port's copy of the JAX package's `engine.physical`: host code, with the
same choices, capacities and `explain()` text.

The optimizer closes the loop the paper leaves to "the query optimizer":

  * **Join ordering** — maximal Join subtrees are flattened into a join
    graph and re-ordered greedily on estimated output cardinality (smallest
    intermediate first), emitting a left-deep tree.
  * **Build-side selection** — the side whose key is *provably* unique
    (exact base-column check + no upstream fan-out, see `_key_is_unique`)
    becomes the build/PK side; if neither side qualifies the join runs in
    m:n mode, which is correct for any multiplicity.
  * **Algorithm + pattern per join** — the paper's Fig. 18 decision tree
    (`core.planner.choose_algorithm`) over a `JoinStats` synthesized from
    the statistics layer (no hand-written descriptors), with the §5.4
    primitive-profile cost model pricing each phase.
  * **Group-by strategy** — `core.groupby.choose_groupby_strategy` on
    estimated group cardinality, key-domain density, and skew.
  * **Capacity propagation** — every operator gets a static output
    capacity (estimate x safety margin, rounded up): the operators keep the
    static-capacity contract of the JAX package.

`PhysicalPlan.explain()` renders the tree with per-operator choice,
estimated rows, capacity, and predicted cost; `PhysicalPlan.run()` hands
the plan to `engine.executor`.

The cost model profile is **calibrated by default** from timed
microbenchmarks on the catalog's device (`PrimitiveProfile.measure()`,
cached per process and in the calibration store). A measurement that fails
raises: no built-in constants stand in for it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping

from ..core import memmodel
from ..core.groupby import PARTITION_ROW_BLOCK, choose_groupby_strategy
from ..core.hash_join import BUILD_BLOCK
from ..core.planner import (JoinStats, PrimitiveProfile, choose_algorithm, choose_smj_pattern,
                            predict_groupby_time, predict_groupjoin_time, predict_join_time)
from ..obs import calibration as cal
from ..obs.residuals import ResidualStore, regret_check
from . import logical as L
from . import stats as S

# in-process profile cache, keyed by (backend fingerprint, calibration n):
# a later call with a different n must re-measure, not silently reuse the
# first profile (pass structure is n-independent but measured bandwidths
# are not, and tests calibrate at several sizes)
_PROFILE_CACHE: dict = {}


def calibrated_profile(n: int = 1 << 16, device=None) -> PrimitiveProfile:
    """Measured primitive profile of `device` (default: the card when there
    is one, else the CPU), cached per (backend, n) in-process AND persisted
    across processes in the calibration store (CALIBRATION.json, keyed by
    backend fingerprint — obs.calibration): the second process on the same
    backend loads the stored constants instead of re-running the
    microbenchmarks. A failed measurement raises: a plan priced by
    constants of another device would look calibrated and not be."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    fp = cal.backend_fingerprint(device)
    key = (fp, n)
    if key in _PROFILE_CACHE:
        return _PROFILE_CACHE[key]
    store = None
    try:
        store = cal.CalibrationStore()
        prof = store.get_profile(fp, n)
    except (ValueError, OSError):  # bad REPRO_CALIBRATION_PATH etc.
        prof = None
    if prof is None:
        prof = PrimitiveProfile.measure(n=n, device=device)
        if store is not None:
            try:
                store.put_profile(fp, n, prof)
                store.save()
            except OSError:
                pass  # read-only checkout: calibration stays in-process
    return _PROFILE_CACHE.setdefault(key, prof)


def _round_capacity(est: float, safety: float, lo: int = 64,
                    hi: int | None = None) -> int:
    cap = max(int(math.ceil(est * safety)), lo)
    cap = -(-cap // 64) * 64  # multiple of 64 keeps shapes lane-friendly
    if hi is not None:
        cap = min(cap, max(hi, lo))
    return cap


class LazyStats:
    """Lazy column-stats mapping: resolves a column to `stats.ColumnStats`
    on first access and caches it. Keeps wide tables cheap — only columns a
    plan consults (keys, filter columns) ever get sketched."""

    def __init__(self, resolve, columns):
        self._resolve = resolve
        self._cols = frozenset(columns)
        self._cache = {}

    def get(self, col, default=None):
        if col not in self._cols:
            return default
        if col not in self._cache:
            self._cache[col] = self._resolve(col)
        return self._cache[col] if self._cache[col] is not None else default

    def __contains__(self, col):
        return self.get(col) is not None

    def __getitem__(self, col):
        v = self.get(col)
        if v is None:
            raise KeyError(col)
        return v


# ---------------------------------------------------------------------------
# Physical nodes
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class PhysNode:
    est_rows: float
    capacity: int
    cost: float  # predicted seconds for this operator alone
    columns: tuple[str, ...]
    col_stats: dict  # column -> stats.ColumnStats (propagated estimates)
    origins: dict  # column -> (base_table, base_column) | None
    # uniqueness bookkeeping for sound pk_fk classification:
    #   may_repeat   — columns whose rows may have been duplicated by an
    #                  upstream join fan-out (base uniqueness no longer holds)
    #   known_unique — columns distinct-valued by construction (group keys)
    may_repeat: frozenset = frozenset()
    known_unique: frozenset = frozenset()

    def children(self) -> tuple["PhysNode", ...]:
        return ()

    def describe(self) -> str:
        raise NotImplementedError


@dataclasses.dataclass
class PScan(PhysNode):
    table: str = ""

    def describe(self):
        return f"Scan[{self.table}] rows={int(self.est_rows)}"


@dataclasses.dataclass
class PFilter(PhysNode):
    child: PhysNode = None
    column: str = ""
    op: str = "=="
    value: float = 0.0
    selectivity: float = 1.0

    def children(self):
        return (self.child,)

    def describe(self):
        return (f"Filter[{self.column} {self.op} {self.value}] "
                f"sel~{self.selectivity:.2f} est~{int(self.est_rows)} "
                f"cap={self.capacity} cost={self.cost*1e6:.0f}us")


@dataclasses.dataclass
class PProject(PhysNode):
    child: PhysNode = None

    def children(self):
        return (self.child,)

    def describe(self):
        return f"Project[{', '.join(self.columns)}]"


@dataclasses.dataclass
class PJoin(PhysNode):
    build: PhysNode = None
    probe: PhysNode = None
    build_key: str = ""
    probe_key: str = ""
    out_key: str = ""
    mode: str = "pk_fk"
    algorithm: str = "phj"
    pattern: str = "gftr"
    rationale: str = ""
    join_stats: JoinStats | None = None
    phase_times: dict | None = None

    def children(self):
        return (self.build, self.probe)

    def describe(self):
        tag = f"{self.algorithm.upper()}-{'OM' if self.pattern == 'gftr' else 'UM'}"
        return (f"Join[{tag} {self.mode}] key={self.out_key} "
                f"mr~{self.join_stats.match_ratio:.2f} est~{int(self.est_rows)} "
                f"cap={self.capacity} cost={self.cost*1e6:.0f}us "
                f"why: {self.rationale}")


@dataclasses.dataclass
class PGroupBy(PhysNode):
    child: PhysNode = None
    key: str = ""
    aggs: tuple = ()
    strategy: str = "sort"
    agg_kw: tuple = ()  # extra group_aggregate kwargs (multiplicity-scaled block)
    rationale: str = ""
    regret: str = ""  # residual-store regret flag (obs.residuals), "" if none

    def children(self):
        return (self.child,)

    def describe(self):
        a = ", ".join(f"{op}({c})" for c, op in self.aggs)
        flag = f" {self.regret}" if self.regret else ""
        return (f"GroupBy[{self.strategy}] key={self.key} aggs=({a}) "
                f"groups~{int(self.est_rows)} cap={self.capacity} "
                f"cost={self.cost*1e6:.0f}us why: {self.rationale}{flag}")


@dataclasses.dataclass
class PGroupJoin(PhysNode):
    """Fused join + grouped aggregation (core.groupjoin.phj_groupjoin):
    the probe feeds a group-keyed accumulator directly, the joined row is
    never materialized. Emitted by the fusion pass when a GroupBy sits on a
    provably pk_fk join, the group key and every aggregate input survive
    the join, and the cost model prices the fusion below the unfused
    join + group-by pair. Capacity is the GROUP-domain estimate (like
    PGroupBy), never the join-output capacity."""
    build: PhysNode = None
    probe: PhysNode = None
    build_key: str = ""
    probe_key: str = ""
    group_key: str = ""  # output column name (the logical GroupBy key)
    probe_group_key: str = ""  # probe-side column actually grouped on
    aggs: tuple = ()
    agg_strategy: str = "sort"
    agg_kw: tuple = ()  # extra accumulator kwargs (multiplicity-scaled block)
    rationale: str = ""
    regret: str = ""  # residual-store regret flag (obs.residuals), "" if none
    join_stats: JoinStats | None = None
    phase_times: dict | None = None

    def children(self):
        return (self.build, self.probe)

    def describe(self):
        a = ", ".join(f"{op}({c})" for c, op in self.aggs)
        flag = f" {self.regret}" if self.regret else ""
        return (f"GroupJoin[phj+{self.agg_strategy} pk_fk] "
                f"key={self.group_key} aggs=({a}) "
                f"groups~{int(self.est_rows)} cap={self.capacity} "
                f"cost={self.cost*1e6:.0f}us why: {self.rationale}{flag}")


@dataclasses.dataclass
class POrderByLimit(PhysNode):
    child: PhysNode = None
    key: str = ""
    limit: int = 0
    descending: bool = False

    def children(self):
        return (self.child,)

    def describe(self):
        d = "desc" if self.descending else "asc"
        return (f"OrderByLimit[{self.key} {d} limit={self.limit}] "
                f"cost={self.cost*1e6:.0f}us")


@dataclasses.dataclass
class PhysicalPlan:
    root: PhysNode
    catalog: "S.Catalog"
    total_cost: float
    # "" normally; "DEGRADED[reason]" when executor.run re-planned this plan
    # after an escalation exhaustion / kernel failure (DESIGN.md §13)
    degraded: str = ""
    # the one-shot degraded re-plan, cached so repeated run() calls reuse
    # it instead of re-degrading
    degraded_plan: "PhysicalPlan | None" = dataclasses.field(
        default=None, repr=False, compare=False)
    # Memory governor (DESIGN.md §15): factor > 1 routes executor.run
    # through the morsel-driven out-of-core driver — the probe/input side
    # splits into `morsel_factor` power-of-two chunks, each run through
    # ONE per-morsel plan, recombined host-side. Set by the memory rung of
    # degrade_plan; 1 = whole-plan execution.
    morsel_factor: int = 1
    # factor -> capacity-scaled per-morsel clone (see morsel_plan), cached
    # so every morsel of every request reuses one plan
    morsel_plans: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def explain(self, verify: bool = False, tables: Mapping | None = None,
                actuals=None) -> str:
        """Render the plan tree: per node its choice, estimated rows,
        capacity and predicted cost, and per join the paper's §4.4 memory
        ledger (core.memmodel) of both patterns. With `verify=True`, run
        every subtree under the auditor (executor.audit), print each node's
        priced contract next to its primitive budget (DESIGN.md §11), and
        raise the first `analysis.ContractViolation` if any budget diverges
        from what the cost model priced — the rendered plan rides along in
        the exception message.

        With `actuals=` (an `obs.trace.QueryTrace` from running THIS plan
        traced), annotate every plan line with the node's predicted vs
        measured time and the measured/modeled residual, flagging >2x
        divergences — the measured side of priced-vs-run (§12)."""
        lines = [f"physical plan  predicted_total={self.total_cost*1e6:.0f}us"]
        if self.degraded:
            lines.append(f"  {self.degraded}")
        plan_audit = None
        if verify:
            from . import executor

            plan_audit = executor.audit(self, tables)
        by_node = plan_audit.by_node() if plan_audit else {}
        spans = actuals.by_path() if actuals is not None else {}

        def walk(node, prefix, is_last, label="", path=()):
            branch = "└─ " if is_last else "├─ "
            lab = f"{label}: " if label else ""
            lines.append(prefix + branch + lab + node.describe())
            ext = "   " if is_last else "│  "
            entry = by_node.get(id(node))
            if entry is not None:
                compiled = entry.own_budget.describe() or "none"
                status = "DIVERGED" if entry.violations else "ok"
                lines.append(
                    f"{prefix}{ext}     priced[{entry.contract.describe()}] "
                    f"compiled[{compiled}] "
                    f"peak-live={entry.report.peak_live_bytes/1024:.0f}KiB "
                    f"{status}")
            if isinstance(node, PJoin):
                n = max(node.build.capacity, node.probe.capacity)
                model = {p: memmodel.peak_memory_bytes(p, n, 4)
                         for p in ("gftr", "gfur")}
                mem = (f"{prefix}{ext}     mem: model["
                       f"gftr={model['gftr']/1024:.0f}KiB "
                       f"gfur={model['gfur']/1024:.0f}KiB] "
                       f"pattern={node.pattern}")
                if entry is not None:
                    mem += f" audited-peak={entry.report.peak_live_bytes/1024:.0f}KiB"
                lines.append(mem)
            span = spans.get(path)
            if span is not None:
                if span.residual is not None:
                    res = f"residual[{span.residual:.2f}x]"
                    if span.residual >= 2.0 or span.residual <= 0.5:
                        res += " ** >2x DIVERGENCE **"
                else:
                    res = "residual[-]"
                lines.append(
                    f"{prefix}{ext}     predicted[{span.predicted_s*1e6:.0f}us] "
                    f"measured[{span.wall_s*1e6:.0f}us] {res}")
            kids = node.children()
            labels = (
                ("build", "probe") if isinstance(node, (PJoin, PGroupJoin))
                else ("",) * len(kids)
            )
            for i, (k, klab) in enumerate(zip(kids, labels)):
                walk(k, prefix + ext, i == len(kids) - 1, klab, path + (i,))

        walk(self.root, "", True)
        # escalation footer: ladder reports recorded while `actuals` ran
        # (trace_execute windows the resilience report ring), so a plan
        # whose checked drivers escalated shows the attempt path next to
        # the measured times they cost
        for rep in getattr(actuals, "escalations", ()) or ():
            lines.append(f"  escalation: {rep.summary()}")
        rendered = "\n".join(lines)
        if plan_audit is not None and plan_audit.violations:
            first = plan_audit.violations[0]
            raise type(first)(f"{first}\n{rendered}")
        return rendered

    def run(self, tables: Mapping | None = None, *, checked: bool = False,
            trace: bool = False, trace_iters: int = 1, trace_warmup: int = 1,
            counts=None):
        """Execute over `tables` (default: the catalog's). Returns
        (Table, valid_count) — or (Table, valid_count, QueryTrace) with
        ``trace=True`` (per-node spans, see obs.trace); see executor.run."""
        from . import executor

        return executor.run(self, tables, checked=checked, trace=trace,
                            trace_iters=trace_iters, trace_warmup=trace_warmup,
                            counts=counts)


# ---------------------------------------------------------------------------
# Optimizer
# ---------------------------------------------------------------------------
class Optimizer:
    def __init__(self, catalog: "S.Catalog", *, profile: PrimitiveProfile | None = None,
                 safety: float = 1.5, measure_profile: bool = True,
                 force_join: tuple[str, str] | None = None,
                 residuals=None):
        self.catalog = catalog
        self.profile = profile or (
            calibrated_profile(device=catalog.device) if measure_profile
            else PrimitiveProfile()
        )
        self.safety = safety
        self.force_join = force_join
        # measured/modeled residual feedback (obs.residuals.ResidualStore);
        # None -> lazily load the catalog device's store from
        # CALIBRATION.json.
        # Advisory only: residuals annotate plans with a regret flag when
        # last run's measurements say the predicted winner lost by >2x —
        # they never flip a choice (the stored ratios may come from
        # different shapes than this query's).
        self._residuals = residuals

    def _residual_store(self):
        if self._residuals is None:
            try:
                self._residuals = cal.load_residuals(
                    fingerprint=cal.backend_fingerprint(self.catalog.device))
            except Exception:  # noqa: BLE001 — obs must never break planning
                self._residuals = ResidualStore()
        return self._residuals

    def _regret(self, op: str, chosen: str, chosen_cost: float,
                alternatives: dict) -> str:
        """Regret flag for a strategy choice: replay it with each
        candidate's predicted time scaled by the residual store's
        measured/modeled EWMA (obs.residuals.regret_check)."""
        try:
            choices = dict(alternatives)
            choices[chosen] = chosen_cost
            return regret_check(self._residual_store(), op, choices, chosen)
        except Exception:  # noqa: BLE001 — obs must never break planning
            return ""

    # -- entry --------------------------------------------------------------
    def optimize(self, plan: L.Plan) -> PhysicalPlan:
        # validate the whole tree up front (raises on bad references)
        L.output_columns(plan, self.catalog.schemas())
        root = self._build(plan)
        total = self._sum_cost(root)
        return PhysicalPlan(root=root, catalog=self.catalog, total_cost=total)

    def _sum_cost(self, node: PhysNode) -> float:
        return node.cost + sum(self._sum_cost(c) for c in node.children())

    # -- per-node construction ----------------------------------------------
    def _build(self, node: L.Plan) -> PhysNode:
        if isinstance(node, L.Scan):
            return self._scan(node)
        if isinstance(node, L.Filter):
            return self._filter(node)
        if isinstance(node, L.Project):
            return self._project(node)
        if isinstance(node, L.Join):
            return self._join_tree(node)
        if isinstance(node, L.GroupBy):
            return self._group_by(node)
        if isinstance(node, L.OrderByLimit):
            return self._order_by(node)
        raise TypeError(f"unknown plan node {type(node).__name__}")

    def _scan(self, node: L.Scan) -> PScan:
        t = self.catalog.tables[node.table]
        name = node.table
        return PScan(
            est_rows=float(t.num_rows), capacity=t.num_rows, cost=0.0,
            columns=tuple(t.column_names),
            col_stats=LazyStats(lambda c: self.catalog.col_stats(name, c),
                                t.column_names),
            origins={c: (name, c) for c in t.column_names},
            table=name,
        )

    def _filter(self, node: L.Filter) -> PFilter:
        child = self._build(node.child)
        origin = child.origins.get(node.column)
        chain = self._scan_chain(child)
        if (origin is not None and chain is not None
                and chain[0] == origin[0]):
            # Scan->Filter* chain: size from the JOINT selectivity of the
            # whole chain on one aligned base sample — independent
            # per-predicate estimates multiply correlated predicates into
            # an underestimate that would truncate survivors.
            preds = chain[1] + ((node.column, node.op, node.value),)
            joint = self.catalog.selectivity(chain[0], preds)
            base_rows = float(self.catalog.tables[chain[0]].num_rows)
            est = base_rows * joint
            sel = est / max(child.est_rows, 1.0)
            cap = _round_capacity(est, self.safety, hi=child.capacity)
        else:
            # The child reshaped the row distribution (join/group-by) or
            # the column is derived: a base-table sample is wrong-weighted
            # (e.g. groups vs rows under skew), so it may guide cost and
            # ordering but must NOT shrink the capacity — compact would
            # silently drop survivors beyond it.
            if origin is not None:
                col = self.catalog.tables[origin[0]][origin[1]]
                sel = S.estimate_selectivity(col, node.op, node.value)
            else:
                sel = 0.33
            est = child.est_rows * sel
            cap = child.capacity
        # one streaming pass over all columns (mask + compact)
        nbytes = child.capacity * 4 * max(len(child.columns), 1)
        cost = 2 * nbytes / self.profile.seq_bw
        return PFilter(
            est_rows=est, capacity=cap, cost=cost, columns=child.columns,
            col_stats=child.col_stats, origins=child.origins,
            may_repeat=child.may_repeat, known_unique=child.known_unique,
            child=child, column=node.column, op=node.op, value=node.value,
            selectivity=sel,
        )

    def _project(self, node: L.Project) -> PProject:
        child = self._build(node.child)
        cols = frozenset(node.columns)
        return PProject(
            est_rows=child.est_rows, capacity=child.capacity, cost=0.0,
            columns=tuple(node.columns),
            col_stats=LazyStats(child.col_stats.get, node.columns),
            origins={c: child.origins.get(c) for c in node.columns},
            may_repeat=child.may_repeat & cols,
            known_unique=child.known_unique & cols,
            child=child,
        )

    # -- joins: flatten, greedy-order, pick algorithms ----------------------
    def _join_tree(self, node: L.Join) -> PhysNode:
        rels, edges = self._flatten(node)
        phys = [self._build(r) for r in rels]
        if not edges:
            return phys[0]
        # greedy: cheapest edge first, then cheapest extension of the
        # connected intermediate
        est_cache = {}

        def edge_est(i, cur, j, e):
            key = (i, id(cur), j)
            if key not in est_cache:
                est_cache[key] = self._estimate_join(cur, phys[j], e)
            return est_cache[key]

        remaining = list(range(len(edges)))
        # seed: globally cheapest edge (the chosen edge's oriented spec is
        # reused by _make_join rather than recomputed)
        seeds = {ei: self._estimate_join(phys[edges[ei][0]],
                                         phys[edges[ei][1]], edges[ei])
                 for ei in remaining}
        seed = min(remaining, key=lambda ei: seeds[ei][0])
        li, ri, lk, rk, mode = edges[seed]
        cur = self._make_join(spec=seeds[seed][1])
        joined = {li, ri}
        remaining.remove(seed)
        while remaining:
            best, best_est = None, None
            for ei in remaining:
                li, ri, lk, rk, mode = edges[ei]
                if li in joined:
                    est = edge_est(ei, cur, ri, (li, ri, lk, rk, mode))
                elif ri in joined:
                    est = edge_est(ei, cur, li, (li, ri, lk, rk, mode))
                else:
                    continue
                if best_est is None or est[0] < best_est[0]:
                    best, best_est = ei, est
            if best is None:  # cannot happen: a Join tree's edge set is connected
                raise ValueError("disconnected join graph")
            li, ri = edges[best][0], edges[best][1]
            remaining.remove(best)
            cur = self._make_join(spec=best_est[1])
            joined.add(ri if li in joined else li)
        return cur

    def _flatten(self, node: L.Plan):
        """Maximal Join subtree -> (leaf relations, edges). Edge =
        (left_rel_idx, right_rel_idx, left_key, right_key, mode)."""
        schemas = self.catalog.schemas()
        if not isinstance(node, L.Join):
            return [node], []
        lrels, ledges = self._flatten(node.left)
        rrels, redges = self._flatten(node.right)
        off = len(lrels)
        edges = ledges + [(a + off, b + off, lk, rk, m)
                          for a, b, lk, rk, m in redges]
        rels = lrels + rrels

        def owner(rel_list, base, key):
            for i, r in enumerate(rel_list):
                if key in L.output_columns(r, schemas):
                    return base + i
            raise KeyError(f"join key {key!r} not found in any input relation")

        li = owner(lrels, 0, node.left_key)
        ri = owner(rrels, off, node.right_key)
        edges.append((li, ri, node.left_key, node.right_key, node.mode))
        return rels, edges

    def _estimate_join(self, a: PhysNode, b: PhysNode, edge):
        """(estimated output rows, oriented spec) for joining phys nodes a
        (carrying edge key ka) and b (carrying kb)."""
        li, ri, lk, rk, mode = edge
        ka = lk if lk in a.columns else rk
        kb = rk if rk in b.columns else lk
        spec = self._orient(a, ka, b, kb, mode)
        return spec["est"], spec

    def _key_is_unique(self, node: PhysNode, col: str) -> bool:
        """PROOF, not estimate, that `col` is distinct-valued in `node`:
        either unique by construction (group key), or its base column is
        exactly unique (Catalog.is_unique) and no upstream join fan-out
        duplicated the rows carrying it. A sketch-based guess here would
        silently drop duplicate matches through the pk_fk path."""
        if col in node.known_unique:
            return True
        if col in node.may_repeat:
            return False
        origin = node.origins.get(col)
        return origin is not None and self.catalog.is_unique(*origin)

    def _scan_chain(self, node: PhysNode):
        """If `node` is a pure Scan -> Filter*/Project* chain over one base
        table (no row duplication or truncation), return (table, predicate
        chain) so estimators can push the predicates into base-row samples;
        else None."""
        preds = []
        cur = node
        while True:
            if isinstance(cur, PScan):
                return cur.table, tuple(preds)
            if isinstance(cur, PFilter):
                preds.append((cur.column, cur.op, cur.value))
                cur = cur.child
            elif isinstance(cur, PProject):
                cur = cur.child
            else:
                return None

    def _orient(self, a: PhysNode, ka: str, b: PhysNode, kb: str, mode: str):
        """Decide build vs probe side + estimate match ratio / output."""
        a_u, b_u = self._key_is_unique(a, ka), self._key_is_unique(b, kb)
        if mode == "pk_fk" and not (a_u or b_u):
            raise ValueError(
                f"join forced to pk_fk but neither key column ({ka!r}, {kb!r}) "
                "is provably unique")
        if mode == "mn" or not (a_u or b_u):
            mode_r = "mn"
            build, bk, probe, pk = ((a, ka, b, kb)
                                    if a.est_rows <= b.est_rows
                                    else (b, kb, a, ka))
        else:
            mode_r = "pk_fk"
            if a_u and b_u:
                build, bk, probe, pk = ((a, ka, b, kb)
                                        if a.est_rows <= b.est_rows
                                        else (b, kb, a, ka))
            elif a_u:
                build, bk, probe, pk = a, ka, b, kb
            else:
                build, bk, probe, pk = b, kb, a, ka

        o_b, o_p = build.origins.get(bk), probe.origins.get(pk)
        if o_b is not None and o_p is not None:
            # Push the probe side's filter chain into the sample when it is
            # a plain Scan->Filter* chain: a predicate correlated with match
            # likelihood then yields the POST-filter match ratio instead of
            # base-mr x selectivity (which double-counts the restriction
            # and under-sizes the output).
            chain = self._scan_chain(probe)
            preds = chain[1] if chain is not None and chain[0] == o_p[0] else ()
            mr = self.catalog.match_ratio(o_b, o_p, preds)
            # A filtered build side can only LOSE keys, so the unscaled mr
            # is an upper bound — safe for capacity, slightly conservative
            # for ordering. (Scaling by row retention is wrong for GroupBy
            # builds; scaling distinct by selectivity is wrong for
            # duplicated keys — both under-size the output.)
        else:
            mr = 0.8  # derived key columns: assume mostly-matching
        mr = min(max(mr, 0.0), 1.0)
        p_stats = probe.col_stats.get(pk)
        zipf = p_stats.zipf if p_stats is not None else 0.0
        if mode_r == "pk_fk":
            est = probe.est_rows * mr
        else:
            # m:n sizing must be an upper bound, or the static capacity
            # silently truncates. Three regimes per side:
            #   Scan->Filter* chain  -> exact masked count is computable
            #   anything else        -> the side may have been fanned out,
            #                           so base-table counts UNDERcount;
            #                           bound via the other side's exact
            #                           max multiplicity, or fully
            #                           pessimistically when neither is
            #                           provable.
            def side_chain(n, origin):
                ch = self._scan_chain(n)
                ok = (ch is not None and origin is not None
                      and ch[0] == origin[0])
                return ch[1] if ok else None

            b_preds = side_chain(build, o_b)
            p_preds = side_chain(probe, o_p)
            if b_preds is not None and p_preds is not None:
                est = self.catalog.mn_output_rows(o_b, o_p, b_preds, p_preds)
            elif b_preds is not None:
                est = probe.est_rows * self.catalog.max_multiplicity(o_b, b_preds)
            elif p_preds is not None:
                est = build.est_rows * self.catalog.max_multiplicity(o_p, p_preds)
            else:
                est = build.est_rows * probe.est_rows  # worst case
        return dict(build=build, build_key=bk, probe=probe, probe_key=pk,
                    mode=mode_r, match_ratio=mr, zipf=zipf, est=est)

    def _make_join(self, a: PhysNode = None, b: PhysNode = None,
                   lk: str = None, rk: str = None, mode: str = "auto",
                   spec: dict | None = None) -> PJoin:
        if spec is None:
            ka = lk if lk in a.columns else rk
            kb = rk if rk in b.columns else lk
            spec = self._orient(a, ka, b, kb, mode)
        build, probe = spec["build"], spec["probe"]
        bk, pk = spec["build_key"], spec["probe_key"]
        jstats = S.synthesize_join_stats(
            n_build=max(int(build.est_rows), 1),
            n_probe=max(int(probe.est_rows), 1),
            build_payload_cols=len(build.columns) - 1,
            probe_payload_cols=len(probe.columns) - 1,
            match_ratio=spec["match_ratio"],
            zipf=spec["zipf"],
            key_dtype=self._dtype_of(build, bk),
            payload_dtypes=[self._dtype_of(n, c)
                            for n in (build, probe)
                            for c in n.columns if c not in (bk, pk)],
        )
        if self.force_join is not None:
            alg, pattern = self.force_join
            rationale = "forced baseline"
        else:
            alg, pattern, rationale = choose_algorithm(jstats)
            if spec["mode"] == "mn" and alg == "phj":
                # PHJ pads each build co-partition to BUILD_BLOCK rows, and
                # duplicates of one key co-hash no matter the fan-out: a
                # heavier per-key multiplicity overflows the block and
                # silently drops matches. Merge join has no such bound.
                chain = self._scan_chain(build)
                o_bk = build.origins.get(bk)
                if (chain is not None and o_bk is not None
                        and chain[0] == o_bk[0]):
                    mult = self.catalog.max_multiplicity(o_bk, chain[1])
                else:
                    mult = float("inf")  # not provable: be safe
                if mult > BUILD_BLOCK:
                    alg = "smj"
                    pattern, _ = choose_smj_pattern(jstats)
                    rationale = (
                        f"m:n build multiplicity {mult:.0f} exceeds PHJ's "
                        f"{BUILD_BLOCK}-row co-partition block -> SMJ")
        phases = predict_join_time(jstats, alg, pattern, self.profile)
        est = spec["est"]
        hi = probe.capacity if spec["mode"] == "pk_fk" else None
        cap = _round_capacity(est, self.safety, hi=hi)
        # Output schema: probe-side key name carries the join key; the
        # build-side key name stays as an equal-valued alias (see
        # logical.output_columns). Payload names must be disjoint.
        out_key = pk
        shared = set(build.columns) & set(probe.columns)
        allowed = {bk} if bk == pk else set()
        if shared - allowed:
            raise ValueError(f"join column name collision: {sorted(shared - allowed)}")
        columns = tuple(probe.columns) + tuple(
            c for c in build.columns if c not in shared
        )
        origins = {}
        for side in (build, probe):
            for c in side.columns:
                origins[c] = side.origins.get(c)
        # BOTH key columns now carry the probe-surviving key values, so both
        # must trace to the probe's base column — leaving the alias pointed
        # at the (unique) build base column would let a later join "prove"
        # the duplicated values unique and drop matches via pk_fk.
        origins[out_key] = probe.origins.get(pk)
        origins[bk] = probe.origins.get(pk)

        # both key columns now hold the matched (probe-surviving) key values
        def _resolve(c, _b=build, _p=probe, _bk=bk, _pk=pk):
            if c in (_pk, _bk):
                ks = _p.col_stats.get(_pk)
                return ks if ks is not None else _b.col_stats.get(_bk)
            if c in _b.columns:
                return _b.col_stats.get(c)
            return _p.col_stats.get(c)

        col_stats = LazyStats(_resolve, columns)
        # uniqueness propagation: pk_fk emits <= 1 row per probe row, so
        # probe-side columns keep their uniqueness; build rows can fan out.
        # The build-key alias carries the probe key's values/multiplicity.
        if spec["mode"] == "pk_fk":
            may_repeat = (probe.may_repeat
                          | (frozenset(build.columns) - {bk}))
            known_unique = probe.known_unique & frozenset(probe.columns)
            if pk in probe.known_unique:
                known_unique |= {bk}
            elif pk in probe.may_repeat:
                may_repeat |= {bk}
        else:
            may_repeat = frozenset(columns)
            known_unique = frozenset()
        return PJoin(
            est_rows=est, capacity=cap, cost=phases["total"], columns=columns,
            col_stats=col_stats, origins=origins,
            may_repeat=may_repeat, known_unique=known_unique,
            build=build, probe=probe, build_key=bk, probe_key=pk,
            out_key=out_key, mode=spec["mode"], algorithm=alg, pattern=pattern,
            rationale=rationale, join_stats=jstats, phase_times=phases,
        )

    def _dtype_of(self, node: PhysNode, col: str):
        origin = node.origins.get(col)
        if origin is not None:
            return self.catalog.tables[origin[0]][origin[1]].dtype
        return "int32"

    # -- group-by / order-by ------------------------------------------------
    def _groupby_choice(self, src: PhysNode, key: str):
        """Group-by strategy, PR-3 partition guard, and accumulator sizing
        over `src`'s rows/statistics — shared by PGroupBy and the fusion
        pass (which applies it to the join's PROBE side: masking unmatched
        rows only removes rows, so every proof below still holds there).

        Returns (strategy, rationale, est_groups, cap, ks, agg_kw) — agg_kw
        is a tuple of extra group_aggregate kwargs (the multiplicity-scaled
        partition block) the executor forwards verbatim."""
        ks = src.col_stats.get(key)
        est_groups = min(ks.distinct if ks else src.est_rows, src.est_rows)
        # scatter indexes the accumulator BY key value and partition radix-
        # buckets hashed key bits: only provably integer keys qualify
        # (int32-casting floats would merge groups). Base-table origin is the
        # primary proof; for derived keys the propagated ColumnStats carries
        # the sketched dtype kind.
        origin = src.origins.get(key)
        integer_key = (origin is not None and S.is_integer_dtype(
            self.catalog.tables[origin[0]][origin[1]].dtype)) or (
                origin is None and ks is not None and ks.integer)
        strategy, rationale = choose_groupby_strategy(
            int(src.est_rows), est_groups,
            key_min=ks.min if ks else None,
            key_max=ks.max if ks else None,
            zipf=ks.zipf if ks else 0.0,
            integer_key=integer_key,
        )
        if strategy == "partition":
            # The executor runs the plain (unchecked) partition path, which
            # silently drops a partition's overhang past its padded block —
            # and a single key's rows co-hash no matter the fan-out. Sampled
            # zipf/distinct sketches can miss one heavy key, so demand the
            # same PROOF the m:n join guard uses: an exact max-multiplicity
            # bound from the base table. Not provable (derived/fanned-out
            # key) or too heavy -> fall back to the always-exact sort.
            chain = self._scan_chain(src)
            if (chain is not None and origin is not None
                    and chain[0] == origin[0]):
                mult = self.catalog.max_multiplicity(origin, chain[1])
            else:
                mult = float("inf")
            # Bound: the layout targets E[partition rows] <= row_block/2,
            # and a key's duplicates co-hash, so multiplicity m inflates the
            # partition-size variance by m. The executor scales the block to
            # PARTITION_ROW_BLOCK * m (below), which keeps the overflow tail
            # at the m-clustered Poisson's 2x-mean point (~e^-0.386*block/2m,
            # vanishing for block/m >= 128) — but only a PROVEN bound makes
            # that sizing sound, and past 8 the padded slot space stops
            # paying for itself (matching the chooser's rows/groups < 8
            # routing threshold).
            if mult > PARTITION_ROW_BLOCK // 16:
                strategy = "sort"
                rationale = (
                    f"high cardinality, but max key multiplicity "
                    f"{'unprovable' if mult == float('inf') else f'{mult:.0f}'}"
                    f" exceeds the partition block's {PARTITION_ROW_BLOCK // 16}"
                    "-row safety bound -> exact sort")
        agg_kw = ()
        if strategy == "partition":
            # Scale the padded block with the PROVEN multiplicity: a key's m
            # duplicates land in one partition, so block/m must stay >= 128
            # for the overflow tail to vanish. The layout keeps
            # E[rows/partition] <= block/2 either way, so the slot space the
            # blocked passes stream over stays ~2-4x n regardless of m.
            m = 1 << max(int(mult) - 1, 0).bit_length()  # next pow2 >= mult
            if m > 1:
                agg_kw = (("row_block", PARTITION_ROW_BLOCK * m),)
        if strategy == "scatter":
            # scatter needs the accumulator to cover the dense domain
            cap = _round_capacity(float(ks.max) + 1, 1.0)
        else:
            cap = _round_capacity(est_groups, self.safety)
        return strategy, rationale, est_groups, cap, ks, agg_kw

    def _group_by(self, node: L.GroupBy) -> PGroupBy:
        child = self._build(node.child)
        strategy, rationale, est_groups, cap, ks, agg_kw = (
            self._groupby_choice(child, node.key))
        # price the geometry the executor will actually run — agg_kw carries
        # the multiplicity-scaled partition block
        cost = predict_groupby_time(child.capacity, len(node.aggs), strategy,
                                    self.profile,
                                    row_block=dict(agg_kw).get("row_block"))
        # Fusion pass: a GroupBy directly over a provably pk_fk join can
        # fold the aggregation into the probe (core.groupjoin) and skip the
        # join materialization round trip entirely. Price both plans; keep
        # whichever the cost model favors, and surface the decision either
        # way so explain() shows it.
        fused = self._try_fuse_group_join(node, child,
                                          unfused_cost=child.cost + cost)
        if fused is not None:
            if fused.cost < child.cost + cost:
                # regret check vs the rejected unfused plan, with BOTH
                # sides residual-corrected (the unfused side splits into
                # the join's and the accumulator's own stored ratios)
                try:
                    store = self._residual_store()
                    unfused_c = (
                        child.cost * store.correction(
                            "join", f"{child.algorithm}/{child.pattern}")
                        + cost * store.correction("groupby", strategy))
                except Exception:  # noqa: BLE001
                    unfused_c = child.cost + cost
                fused.regret = self._regret(
                    "groupjoin", f"phj+{fused.agg_strategy}", fused.cost,
                    {"join+groupby": unfused_c})
                return fused
            rationale += (
                f"; fusion rejected: GroupJoin {fused.cost*1e6:.0f}us >= "
                f"join+group-by {(child.cost + cost)*1e6:.0f}us")
        # regret flag: replay the strategy choice with residual-corrected
        # costs — flags (never flips) a chooser whose predicted winner
        # lost by >2x in this backend's residual store
        regret = self._regret(
            "groupby", strategy, cost,
            {s: predict_groupby_time(child.capacity, len(node.aggs), s,
                                     self.profile)
             for s in ("sort", "partition", "partition_hash")
             if s != strategy})
        col_stats = {node.key: ks} if ks else {}
        return PGroupBy(
            est_rows=min(est_groups, cap), capacity=cap, cost=cost,
            columns=(node.key,) + tuple(f"{c}_{op}" for c, op in node.aggs),
            col_stats=col_stats,
            origins={node.key: child.origins.get(node.key)},
            known_unique=frozenset({node.key}),  # one row per group
            child=child, key=node.key, aggs=tuple(node.aggs),
            strategy=strategy, agg_kw=agg_kw, rationale=rationale,
            regret=regret,
        )

    def _try_fuse_group_join(self, node: L.GroupBy, child: PhysNode,
                             unfused_cost: float) -> "PGroupJoin | None":
        """PGroupJoin candidate for GroupBy(Join(...)): the group key and
        every aggregate input must survive the join, and the join must be
        provably pk_fk (the fused probe takes one match per probe row; an
        m:n fan-out would silently drop aggregate contributions). Returns
        None when the pattern doesn't match; the CALLER prices the
        candidate against the unfused plan — `unfused_cost` only feeds the
        rationale string."""
        if self.force_join is not None or not isinstance(child, PJoin):
            return None
        if child.mode != "pk_fk" or child.algorithm != "phj":
            return None
        build, probe = child.build, child.probe
        bk, pk = child.build_key, child.probe_key
        # group key must be probe-side; the build-key alias carries the same
        # probe-surviving values, so it qualifies via the probe key. A probe
        # column SHADOWING the build-key name cannot reach here: the join
        # name-collision check (logical.output_columns / _make_join) rejects
        # that plan outright when bk != pk, and when bk == pk the two
        # branches below coincide.
        if node.key in probe.columns:
            probe_gk = node.key
        elif node.key == bk:
            probe_gk = pk
        else:
            return None
        # aggregate inputs survive on one side (the bk alias is excluded:
        # its values live on the probe side under a different name)
        for c, _ in node.aggs:
            if c not in probe.columns and (c not in build.columns or c == bk):
                return None

        # strategy + capacity from the shared chooser, applied to the PROBE
        # side: the accumulator is GROUP-domain sized (never join-output
        # sized), and the integer-key / PR-3 partition-multiplicity proofs
        # transfer unchanged — masking unmatched rows only removes rows
        strategy, _, est_groups, cap, ks, agg_kw = self._groupby_choice(
            probe, probe_gk)
        build_aggs = sum(1 for c, _ in node.aggs if c not in probe.columns)
        phases = predict_groupjoin_time(
            child.join_stats, len(node.aggs), strategy, self.profile,
            group_key_carried=(probe_gk == pk), build_aggs=build_aggs,
            agg_row_block=dict(agg_kw).get("row_block"))
        rationale = (
            f"fused: probe feeds the accumulator, join never materialized; "
            f"GroupJoin {phases['total']*1e6:.0f}us vs join+group-by "
            f"{unfused_cost*1e6:.0f}us")
        return PGroupJoin(
            est_rows=min(est_groups, cap), capacity=cap,
            cost=phases["total"],
            columns=(node.key,) + tuple(f"{c}_{op}" for c, op in node.aggs),
            col_stats={node.key: ks} if ks else {},
            origins={node.key: probe.origins.get(probe_gk)},
            known_unique=frozenset({node.key}),  # one row per group
            build=build, probe=probe, build_key=bk, probe_key=pk,
            group_key=node.key, probe_group_key=probe_gk,
            aggs=tuple(node.aggs), agg_strategy=strategy, agg_kw=agg_kw,
            rationale=rationale, join_stats=child.join_stats,
            phase_times=phases,
        )

    def _order_by(self, node: L.OrderByLimit) -> POrderByLimit:
        child = self._build(node.child)
        cap = min(node.limit, child.capacity)
        cost = self.profile.sort_cost(child.capacity, 4, 4 * len(child.columns))
        return POrderByLimit(
            est_rows=min(child.est_rows, node.limit), capacity=cap, cost=cost,
            columns=child.columns, col_stats=child.col_stats,
            origins=dict(child.origins), may_repeat=child.may_repeat,
            known_unique=child.known_unique, child=child, key=node.key,
            limit=node.limit, descending=node.descending,
        )


# ---------------------------------------------------------------------------
# morsel-driven out-of-core execution (DESIGN.md §15)
# ---------------------------------------------------------------------------
def _subtree_scans(node: PhysNode) -> list:
    """All scan table names in `node`'s subtree (with repeats)."""
    if isinstance(node, PScan):
        return [node.table]
    names: list = []
    for child in node.children():
        names += _subtree_scans(child)
    return names


def morsel_axis(root: PhysNode) -> str | None:
    """Name of the scan table the morsel driver may split, or None when the
    plan is not splittable.

    The axis is the PROBE spine's base scan: walking root -> probe/child,
    every probe row is independent (filters, projections, and joins against
    whole off-spine build sides commute with splitting the probe), so
    running the plan per probe-chunk and recombining is exact. Not
    splittable: a group-by/group-join anywhere but the root (its output
    feeds more plan — partials would leak upward), an order-by-limit
    (top-k is not a per-chunk concat), or an axis table that also appears
    on a build side (self-join: splitting one occurrence but not the other
    changes the result)."""
    off_spine: list = []
    node = root
    if isinstance(node, PGroupBy):
        node = node.child
    elif isinstance(node, PGroupJoin):
        off_spine += _subtree_scans(node.build)
        node = node.probe
    while True:
        if isinstance(node, (PGroupBy, PGroupJoin, POrderByLimit)):
            return None
        if isinstance(node, (PFilter, PProject)):
            node = node.child
        elif isinstance(node, PJoin):
            off_spine += _subtree_scans(node.build)
            node = node.probe
        elif isinstance(node, PScan):
            return None if node.table in off_spine else node.table
        else:
            return None


def morsel_rows(rows: int, factor: int) -> int:
    """Per-morsel axis rows for splitting `rows` into `factor` chunks:
    ceil-divided, lane-rounded, never below the 64-row floor."""
    m = -(-max(int(rows), 1) // int(factor))
    return max(-(-m // 64) * 64, 64)


def partial_agg_plan(node: PhysNode):
    """Partial-aggregate rewrite for running a root group node per-morsel:
    ``(partial_aggs, count_col)``.

    Each original aggregate maps to a recombinable partial (sum/count/
    min/max pass through; mean becomes a sum partial). `count_col` is the
    column whose ``<col>_count`` partial carries the per-group row count
    that mean finalization divides by — `count` is column-independent
    (it counts the group's rows), so any column free of a conflicting
    partial works; the group key is preferred. None when no mean
    aggregate. Raises ValueError when no conflict-free rewrite exists
    (the plan is then not morsel-splittable)."""
    if isinstance(node, PGroupBy):
        key, avail = node.key, tuple(node.child.columns)
    elif isinstance(node, PGroupJoin):
        # build_key is renamed to the probe key inside the fused driver, so
        # it cannot carry a partial; every other input column survives
        key = node.probe_group_key
        avail = tuple(node.probe.columns) + tuple(
            c for c in node.build.columns
            if c not in node.probe.columns and c != node.build_key)
    else:
        raise TypeError(f"not a group node: {type(node).__name__}")
    partial: dict = {}
    for c, op in node.aggs:
        pop = "sum" if op == "mean" else op
        if partial.get(c, pop) != pop:
            raise ValueError(
                f"column {c!r} needs both {partial[c]!r} and {pop!r} "
                "partials; plan is not morsel-splittable")
        partial[c] = pop
    count_col = None
    if any(op == "mean" for _, op in node.aggs):
        count_col = next((c for c, pop in partial.items() if pop == "count"),
                         None)
        if count_col is None:
            count_col = next(
                (c for c in (key,) + avail if c not in partial), None)
            if count_col is None:
                raise ValueError(
                    "no free column to carry the count partial for mean; "
                    "plan is not morsel-splittable")
            partial[count_col] = "count"
    return tuple(partial.items()), count_col


def morsel_plan(plan: PhysicalPlan, factor: int,
                rows: int | None = None) -> PhysicalPlan:
    """Per-morsel clone of `plan` for one chunk of ``morsel_rows(rows,
    factor)`` axis rows (rows defaults to the catalog's axis table).

    Spine capacities whose output is row-bounded by the chunk shrink to
    the chunk size — filters and pk_fk joins emit at most one row per
    probe row, so ``min(capacity, m)`` is exact; m:n joins and anything
    above them keep full capacity. A root group node's aggregates are
    rewritten to their recombinable partials (`partial_agg_plan`) with
    capacity UNCHANGED: scatter accumulators are domain-indexed and any
    morsel may see every group. Clones are cached on
    ``plan.morsel_plans`` keyed by (factor, m), so every morsel of every
    request reuses one plan."""
    axis = morsel_axis(plan.root)
    if axis is None:
        raise ValueError("plan has no morsel axis (not splittable)")
    if rows is None:
        rows = plan.catalog.tables[axis].num_rows
    m = morsel_rows(rows, factor)
    key = (int(factor), m)
    cached = plan.morsel_plans.get(key)
    if cached is not None:
        return cached

    def clone(node: PhysNode):
        """(clone, bounded) — bounded: output rows <= m by construction
        (a row-nonincreasing chain from the axis scan)."""
        if isinstance(node, PScan):
            return node, node.table == axis
        if isinstance(node, PFilter):
            child, bounded = clone(node.child)
            changes = {"child": child} if child is not node.child else {}
            if bounded:
                changes["capacity"] = min(node.capacity, m)
            return (dataclasses.replace(node, **changes) if changes
                    else node), bounded
        if isinstance(node, PProject):
            child, bounded = clone(node.child)
            out = (dataclasses.replace(node, child=child)
                   if child is not node.child else node)
            return out, bounded
        if isinstance(node, PJoin):
            build, _ = clone(node.build)
            probe, p_bounded = clone(node.probe)
            bounded = p_bounded and node.mode == "pk_fk"
            changes = {}
            if build is not node.build:
                changes["build"] = build
            if probe is not node.probe:
                changes["probe"] = probe
            if bounded:
                changes["capacity"] = min(node.capacity, m)
            return (dataclasses.replace(node, **changes) if changes
                    else node), bounded
        if isinstance(node, (PGroupBy, PGroupJoin)):
            # only legal at the root (morsel_axis guarantees)
            partial, _ = partial_agg_plan(node)
            if isinstance(node, PGroupBy):
                child, _ = clone(node.child)
                cols = (node.key,) + tuple(f"{c}_{op}" for c, op in partial)
                return dataclasses.replace(
                    node, child=child, aggs=partial, columns=cols), False
            build, _ = clone(node.build)
            probe, _ = clone(node.probe)
            cols = (node.group_key,) + tuple(
                f"{c}_{op}" for c, op in partial)
            return dataclasses.replace(
                node, build=build, probe=probe, aggs=partial,
                columns=cols), False
        return node, False

    root, _ = clone(plan.root)
    mp = PhysicalPlan(root=root, catalog=plan.catalog,
                      total_cost=plan.total_cost / factor,
                      degraded=f"MORSEL[{factor}]")
    plan.morsel_plans[key] = mp
    return mp


# ---------------------------------------------------------------------------
# graceful degradation (DESIGN.md §13): the executor's one-shot re-plan
# ---------------------------------------------------------------------------
def degrade_plan(plan: PhysicalPlan, reason: str, *,
                 memory: bool = False) -> PhysicalPlan:
    """A conservative clone of `plan` for executor.run's single retry after
    an escalation exhaustion or operator failure: every data-bearing
    capacity doubles (lane-rounded — wrong estimates are the common failure
    mode), group-bys and fused group-joins fall to the always-exact 'sort'
    strategy, and PHJ joins fall to sort-merge (exact for any key
    multiplicity). The clone shares the catalog, and is annotated
    `DEGRADED[reason]` for explain().

    ``memory=True`` selects the MEMORY rung instead (DESIGN.md §15): an
    allocation failure must get a SMALLER working set, never the doubled
    capacities of the default rung. The clone shares the root and the
    morsel-plan cache and doubles ``morsel_factor`` (2 on first entry), so
    executor.run routes it through the morsel-driven out-of-core driver.
    Raises ValueError when the plan has no morsel axis — the caller must
    check `morsel_axis` first (an unsplittable plan's memory failure is
    terminal)."""
    if memory:
        if morsel_axis(plan.root) is None:
            raise ValueError("plan has no morsel axis (not splittable)")
        factor = max(plan.morsel_factor * 2, 2)
        return PhysicalPlan(
            root=plan.root, catalog=plan.catalog,
            total_cost=plan.total_cost,
            degraded=f"DEGRADED[{reason}] MORSEL[x{factor}]",
            morsel_factor=factor, morsel_plans=plan.morsel_plans)

    def clone(node: PhysNode) -> PhysNode:
        changes: dict = {}
        if isinstance(node, (PFilter, PProject, PGroupBy, POrderByLimit)):
            changes["child"] = clone(node.child)
        elif isinstance(node, (PJoin, PGroupJoin)):
            changes["build"] = clone(node.build)
            changes["probe"] = clone(node.probe)
        # OrderByLimit's capacity IS the limit (growing it would return
        # extra rows); Scan/Project capacities mirror their input
        if isinstance(node, (PFilter, PJoin, PGroupBy, PGroupJoin)):
            changes["capacity"] = -(-node.capacity * 2 // 64) * 64
        if isinstance(node, PGroupBy) and node.strategy != "sort":
            changes.update(strategy="sort", agg_kw=(),
                           rationale=node.rationale + "; degraded -> sort")
        if isinstance(node, PGroupJoin) and node.agg_strategy != "sort":
            changes.update(agg_strategy="sort", agg_kw=())
        if isinstance(node, PJoin) and node.algorithm == "phj":
            changes.update(algorithm="smj",
                           rationale=node.rationale + "; degraded -> smj")
        return dataclasses.replace(node, **changes) if changes else node

    return PhysicalPlan(root=clone(plan.root), catalog=plan.catalog,
                        total_cost=plan.total_cost,
                        degraded=f"DEGRADED[{reason}]")


def optimize(plan: L.Plan, catalog: "S.Catalog", *,
             profile: PrimitiveProfile | None = None, safety: float = 1.5,
             measure_profile: bool = True,
             force_join: tuple[str, str] | None = None,
             residuals=None) -> PhysicalPlan:
    """Optimize a logical plan against a catalog. See module docstring."""
    return Optimizer(catalog, profile=profile, safety=safety,
                     measure_profile=measure_profile, force_join=force_join,
                     residuals=residuals).optimize(plan)
