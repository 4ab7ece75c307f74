"""Run one cell of the port's benchmark once and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of `workloads` in BENCHMARK.json. The run draws its
tables on the card from the seed, sets up what the cell's traffic drives,
offers queries for `--seconds`, checks every answer against the plain
reference, and prints, as the last line of standard output, one JSON
object: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer ones), `device` (and
`breakdown` with `--trace 1`), and last `checks`, each number compared with
its limit. The same numbers end standard error. It exits non-zero, with no
result line, without an NVIDIA GPU, without the port beside this folder,
where a traced run's per-layer metric listed for the cell reads nothing,
and where `jax`, `jaxlib`, `flax` or the JAX package `repro` is loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out[0] if out else "nvidia-smi printed nothing"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    # the program's calibration store: read and written under TMPDIR only
    os.environ["REPRO_CALIBRATION_PATH"] = os.path.join(tempfile.gettempdir(),
                                                        "repro_torch_calibration.json")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from bench import harness, registry

    spec = registry.load_spec()
    parts = registry.cell_parts(spec, args.workload)
    chips = parts["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} NVIDIA GPU(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} found",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    print(f"card: {card_line()}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)
    _build.build_all()
    out = harness.run_cell(parts, args.seed, args.seconds, bool(args.trace), "cuda",
                           t_start=T_START)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    if args.trace and out["silent"]:
        print(f"error: per-layer metrics of this cell read nothing: {out['silent']}",
              file=sys.stderr)
        return 1
    harness.refuse_forbidden()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
