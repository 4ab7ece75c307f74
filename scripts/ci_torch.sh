#!/usr/bin/env bash
# The PyTorch port's CI: the gates of scripts/ci.sh with the port's tests
# and CLIs, all on the CPU (--device cpu), runnable from any checkout with
# no env setup:
#
#   scripts/ci_torch.sh                               # every tests/test_torch_*.py
#   scripts/ci_torch.sh tests/test_torch_isolation.py # the gates on a test selection
#   scripts/ci_torch.sh -k parity                     # options go to pytest too
#
# Arguments go to pytest as in ci.sh; when one of them names tests, it
# replaces the default selection. The CLIs write their artifacts
# (ANALYSIS.json, dryrun/, TRACE.json, CALIBRATION.json, RESILIENCE_SMOKE.json,
# BENCH_serve_torch.json) into $CI_TORCH_OUT (default build/ci_torch), and
# the calibration store lives there unless REPRO_CALIBRATION_PATH names
# another.
#
# Two of ci.sh's gates have no counterpart in the port and are not asserted:
# the chaos soak's `pallas` family and the resilience smoke's
# `resilience.kernel_fallbacks` (the port never degrades around a kernel:
# a kernel that fails raises KernelError, ROADMAP Queue 3), and the
# smoke-scale benchmark gates (benchmarks/ is not ported).
set -euo pipefail
cd "$(dirname "$0")/.."
ROOT=$PWD
export PYTHONPATH="$ROOT/src${PYTHONPATH:+:$PYTHONPATH}"
OUT="${CI_TORCH_OUT:-$ROOT/build/ci_torch}"
mkdir -p "$OUT"
export REPRO_CALIBRATION_PATH="${REPRO_CALIBRATION_PATH:-$OUT/CALIBRATION.json}"

selection=(tests/test_torch_*.py)
for arg in "$@"; do
    case "$arg" in -*) ;; *) selection=(); break ;; esac
done
python -m pytest -x -q ${selection[@]+"${selection[@]}"} "$@"

cd "$OUT"

# Static-analysis hard gate: every operator entry point, kernel launch and
# source, and optimizer-chosen plan must honor its contract
# (repro_torch.analysis exits non-zero on any ContractViolation).
python -m repro_torch.analysis --device cpu --out ANALYSIS.json > /dev/null
test -s ANALYSIS.json
python - <<'PY'
import json
rep = json.load(open("ANALYSIS.json"))
assert rep["summary"]["violations"] == 0, rep["summary"]
assert rep["operators"] and rep["kernels"] and rep["engine"]
PY
echo "ci_torch: repro_torch.analysis contract sweep OK (ANALYSIS.json, 0 violations)"

# Dry-run gate: the sharded train step of the reduced olmo-1b traced on a
# (2, 4) mesh of a fake process group (repro_torch.launch.dryrun, its own
# process), status ok with collectives counted.
python -m repro_torch.launch.dryrun --arch olmo-1b --shape train_4k --mesh single \
    --reduced --out dryrun > /dev/null
python - <<'PY'
import json
rec = json.load(open("dryrun/olmo-1b__train_4k__single.json"))
assert rec["status"] == "ok", (rec["status"], rec.get("error"))
assert sum(rec["collectives"]["counts"].values()) > 0, rec["collectives"]
PY
echo "ci_torch: dry run OK (dryrun/olmo-1b__train_4k__single.json, status ok)"

# Observability smoke: every trace node carries predicted + measured +
# residual, and the calibration store holds a device profile and non-empty
# residual EWMAs for the traced backend (DESIGN.md §12).
python -m repro_torch.obs --smoke --device cpu > /dev/null
test -s TRACE.json
test -s "$REPRO_CALIBRATION_PATH"
python - <<'PY'
import json
import os
tr = json.load(open("TRACE.json"))
assert tr["backend"] and tr["queries"], "TRACE.json missing backend/queries"
for name, q in tr["queries"].items():
    assert q["nodes"], (name, "no nodes")
    for node in q["nodes"]:
        for key in ("predicted_s", "measured_s", "residual",
                    "op", "rows_out", "path"):
            assert key in node, (name, node.get("op"), "missing", key)
        assert node["measured_s"] > 0, (name, node["op"], "unmeasured")
cal = json.load(open(os.environ["REPRO_CALIBRATION_PATH"]))
ent = cal[tr["backend"]]
assert ent["profiles"], "CALIBRATION.json entry has no device profile"
assert ent["residuals"], "CALIBRATION.json entry has no residual EWMAs"
assert all("ewma" in r and "count" in r for r in ent["residuals"].values())
PY
echo "ci_torch: obs traced smoke OK (TRACE.json + CALIBRATION.json schemas)"

# Fault-injection smoke (DESIGN.md §13): one forced overflow per escalation
# ladder, one forced executor failure and one forced oom. The run must
# complete with results identical to the fault-free oracles AND the
# resilience.* counters must be non-zero.
python -m repro_torch.resilience --smoke --device cpu > RESILIENCE_SMOKE.json
python - <<'PY'
import json
rep = json.load(open("RESILIENCE_SMOKE.json"))
assert rep["ok"] and not rep["failures"], rep["failures"]
assert all(c["ok"] for c in rep["cases"]), rep["cases"]
for name in ("resilience.ladder_escalations", "resilience.plan_degradations",
             "resilience.oom_injected", "resilience.faults_fired"):
    assert rep["metrics"].get(name, 0) > 0, (name, rep["metrics"])
PY
echo "ci_torch: resilience fault-injection smoke OK (RESILIENCE_SMOKE.json, all counters moved)"

# Smoke-scale chaos/soak gate (DESIGN.md §14): delivered results
# bit-identical to fault-free oracles, failures confined to the faulted
# signature, breaker/saturation counters consistent with the injected
# faults, and the memory governor's morsels and rejections.
python -m repro_torch.serve --chaos --smoke --device cpu --out BENCH_serve_torch.json > /dev/null
test -s BENCH_serve_torch.json
python - <<'PY'
import json
rep = json.load(open("BENCH_serve_torch.json"))
assert rep["ok"] and not rep["failures"], rep["failures"]
base = rep["baseline"]
for key in ("p50_s", "p95_s", "p99_s", "throughput_qps"):
    assert base[key] > 0, (key, base)
assert base["plan_cache_hits"] > base["plans_compiled"], base
for fam, f in rep["families"].items():
    assert f["wrong_results"] == 0 and f["contaminated"] == 0, (fam, f)
    assert f["confinement"], (fam, "no confinement evidence")
fams = rep["families"]
assert fams["raise"]["counters"]["qserve.failed"] == fams["raise"]["expected_failed"] > 0
assert fams["raise"]["counters"]["qserve.breaker_opens"] >= 1
assert fams["raise"]["counters"]["qserve.breaker_closes"] >= 1
assert fams["estimates"]["counters"]["qserve.saturations"] > 0
assert fams["overflow"]["counters"]["resilience.ladder_escalations"] > 0
assert rep["pressure"]["shed"] == 6 and rep["pressure"]["deadline"] == 2
assert rep["pressure"]["rejected"] == 2
mem = rep["memory"]
assert mem["chunked_runs"] > 0, mem
assert mem["mem_rejections"] > 0, mem
assert mem["reserved_le_budget"] is True, mem
assert mem["wrong_results"] == 0, mem
assert mem["oom_injected"] > 0, mem
PY
echo "ci_torch: smoke-scale serve chaos soak OK (BENCH_serve_torch.json, all families clean)"
