"""The port's example twins against the JAX package's examples, on the
CPU.

`examples/quickstart_torch.py` and `examples/relational_analytics_torch.py`
run with `--device cpu` beside `examples/quickstart.py` and
`examples/relational_analytics.py`, each in its own process, one after the
other and on one thread (the suite's other workers share the cores), and
print the same lines: the same text and the same integers, and
the same decimals within their printed digits. The one float computed in
another order, the quickstart's total revenue (a float32 sum over 30,000
join rows), is held within sqrt(rows) x 2^-24 relative. Both packages price
their plans with one profile, stored under both backends' fingerprints in
a calibration store of the test's own (`REPRO_CALIBRATION_PATH`), so the
plans' costs are the same numbers.
"""
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.obs import calibration as jcal  # noqa: E402
from repro_torch.core.planner import PrimitiveProfile  # noqa: E402
from repro_torch.obs import calibration as tcal  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
NUMBER = re.compile(r"-?\d+(?:\.\d+)?")
# float32 sums of 30,000 products in another order: the random-walk size of
# 30,000 roundings of 2^-24 relative (1.03e-5, 31 of the 3,024,381 printed),
# so one row lost or doubled (101 on average) shows. Both packages printed
# the same total.
REVENUE_RTOL = 30_000 ** 0.5 * 2.0 ** -24


@pytest.fixture
def env(tmp_path):
    """Subprocess environment: the repo's src/ on the path, JAX and torch on
    the CPU with one thread, and a calibration store holding the port's
    default profile under the JAX package's fingerprint and the port's CPU
    fingerprint."""
    path = tmp_path / "CALIBRATION.json"
    profile = dataclasses.asdict(PrimitiveProfile())
    store = {fp: {"profiles": {str(1 << 16): profile}}
             for fp in (jcal.backend_fingerprint(), tcal.backend_fingerprint("cpu"))}
    path.write_text(json.dumps(store))
    return dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
                OMP_NUM_THREADS="1", REPRO_CALIBRATION_PATH=str(path),
                XLA_FLAGS="--xla_cpu_multi_thread_eigen=false")


def _run_pair(env, jax_script: str, torch_script: str) -> tuple[list[str], list[str]]:
    """The JAX example, then the port's, from the repo's root; their stdout
    lines."""
    outs = []
    for script, extra in ((jax_script, ()), (torch_script, ("--device", "cpu"))):
        p = subprocess.run([sys.executable, str(REPO / "examples" / script), *extra],
                           capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
        assert p.returncode == 0, p.stderr[-4000:]
        outs.append(p.stdout.splitlines())
    return outs[0], outs[1]


def _split(line: str):
    """(the line with its numbers replaced by '#', its numbers as text)."""
    return NUMBER.sub("#", line), NUMBER.findall(line)


def _same_lines(want: list[str], got: list[str], float_rtol=None):
    """Same text and integers; decimals equal to their printed digits;
    `float_rtol` maps a line's prefix to a relative tolerance for its
    numbers (sums taken in another order)."""
    assert len(got) == len(want), (want, got)
    for w, g in zip(want, got):
        (wt, wn), (gt, gn) = _split(w), _split(g)
        assert gt == wt and len(gn) == len(wn), (w, g)
        rtol = next((t for p, t in (float_rtol or {}).items() if w.startswith(p)), None)
        for a, b in zip(wn, gn):
            if rtol is not None and a != b:
                assert abs(float(a) - float(b)) <= rtol * abs(float(a)), (w, g)
            elif "." in a:
                step = 10.0 ** -len(a.split(".")[1])
                assert abs(float(a) - float(b)) <= step, (w, g)
            else:
                assert a == b, (w, g)


def test_quickstart_twin_prints_the_jax_examples_lines(env):
    want, got = _run_pair(env, "quickstart.py", "quickstart_torch.py")
    assert len(want) == 6 and want[0].startswith("SMJ-UM: 30000 matches")
    _same_lines(want, got, float_rtol={"group-by:": REVENUE_RTOL})
    # the group count on the same line is an integer, held exactly
    assert _split(got[4])[1][0] == _split(want[4])[1][0]


def test_relational_analytics_twin_prints_the_jax_examples_lines(env):
    want, got = _run_pair(env, "relational_analytics.py", "relational_analytics_torch.py")
    assert any("Join[" in line for line in want) and want[-1].startswith("top-8 of")
    assert sum(line.startswith(("J1:", "J3:", "J4:")) for line in want) == 3
    assert "star query:" in want
    _same_lines(want, got)


def test_twins_exit_1_without_a_card(env):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    for script in ("quickstart_torch.py", "relational_analytics_torch.py"):
        p = subprocess.run([sys.executable, str(REPO / "examples" / script)],
                           capture_output=True, text=True, env=env, cwd=REPO, timeout=120)
        assert p.returncode == 1 and "--device cpu" in p.stderr and not p.stdout
