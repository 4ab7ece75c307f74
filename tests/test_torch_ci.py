"""The port's CI script on the CPU: `scripts/ci_torch.sh
tests/test_torch_isolation.py` runs every gate of the port's CI (its tests,
the analysis sweep with its kernels section, the dry run of the reduced
olmo-1b on a fake process group, the obs smoke's schemas, the resilience
smoke, the serve chaos smoke) on a small test selection, its
artifacts in a directory of the test's own. (Beside the example twins in
tests/test_torch_examples.py it would hold one test worker for about two
minutes.)"""
import os
import subprocess
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent


def test_ci_torch_script_passes_on_a_small_selection(tmp_path):
    out = tmp_path / "ci"
    # a clean environment: the nested pytest must not inherit the calling
    # pytest worker's variables (PYTEST_XDIST_WORKER, PYTEST_ADDOPTS, ...)
    # nor the port's REPRO_* knobs
    run_env = {k: v for k, v in os.environ.items() if not k.startswith(("PYTEST_", "REPRO_"))}
    run_env.update(PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1", CI_TORCH_OUT=str(out))
    p = subprocess.run(["bash", str(REPO / "scripts" / "ci_torch.sh"),
                        "tests/test_torch_isolation.py", "-p", "no:cacheprovider"],
                       capture_output=True, text=True, env=run_env, cwd=REPO, timeout=600)
    assert p.returncode == 0, (p.stdout[-4000:], p.stderr[-4000:])
    gates = [line for line in p.stdout.splitlines() if line.startswith("ci_torch:")]
    assert len(gates) == 5 and all(" OK " in line for line in gates), gates
    for name in ("ANALYSIS.json", "TRACE.json", "CALIBRATION.json", "RESILIENCE_SMOKE.json",
                 "BENCH_serve_torch.json", "dryrun/olmo-1b__train_4k__single.json"):
        assert (out / name).stat().st_size > 0, name
