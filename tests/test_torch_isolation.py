"""The PyTorch port stands alone: neither the package (its kernel lint and
its distributed layer included: importing them starts no process group),
nor its examples (examples/*_torch.py: the quickstart, the
relational analytics, the pipeline and the LM twins), nor chip_smoke.py
imports JAX or the JAX package."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = ("import sys\n"
            "import repro_torch, repro_torch.core, repro_torch.kernels, repro_torch.data\n"
            "import repro_torch.kernels.ops, repro_torch.kernels._build\n"
            "import repro_torch.core.sort_merge, repro_torch.core.nphj, repro_torch.data.relgen\n"
            "import repro_torch.core.phases, repro_torch.core.table\n"
            "import repro_torch.kernels.merge_join, repro_torch.kernels.histogram\n"
            "import repro_torch.obs, repro_torch.obs.metrics, repro_torch.resilience\n"
            "import repro_torch.resilience.faults, repro_torch.resilience.escalation\n"
            "import repro_torch.core.groupby, repro_torch.core.groupjoin\n"
            "import repro_torch.core.hash_join, repro_torch.core.planner\n"
            "import repro_torch.core.memmodel\n"
            "import repro_torch.engine, repro_torch.engine.logical, repro_torch.engine.stats\n"
            "import repro_torch.engine.physical, repro_torch.engine.executor\n"
            "import repro_torch.engine.membudget, repro_torch.obs.calibration\n"
            "import repro_torch.obs.residuals, repro_torch.obs.trace, repro_torch.obs.__main__\n"
            "import repro_torch.analysis, repro_torch.analysis.dispatch_audit\n"
            "import repro_torch.analysis.contracts, repro_torch.analysis.__main__\n"
            "import repro_torch.analysis.kernel_lint\n"
            "import repro_torch.serve, repro_torch.serve.query, repro_torch.serve.chaos\n"
            "import repro_torch.serve.__main__, repro_torch.resilience.__main__\n"
            "import repro_torch.configs, repro_torch.configs.base\n"
            "from repro_torch.configs.base import get_config, list_archs\n"
            "[get_config(a) for a in list_archs()]\n"
            "import repro_torch.models, repro_torch.models.params, repro_torch.models.layers\n"
            "import repro_torch.models.moe, repro_torch.models.model\n"
            "import repro_torch.dist, repro_torch.dist.sharding\n"
            "import repro_torch.serve.engine, repro_torch.launch, repro_torch.launch.serve\n"
            "import repro_torch.data.synthetic, repro_torch.models.flops\n"
            "import repro_torch.train, repro_torch.train.optimizer, repro_torch.train.step\n"
            "import repro_torch.train.checkpoint, repro_torch.train.loop\n"
            "import repro_torch.launch.train\n"
            "import repro_torch.models.ssm, repro_torch.models.xlstm\n"
            "import repro_torch.data.pipeline\n"
            "import repro_torch.dist.collectives, repro_torch.dist.pipeline\n"
            "import repro_torch.train.elastic, repro_torch.launch.mesh\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.roofline\n"
            "import repro_torch.launch.report\n"
            "import torch.distributed as dist\n"
            "assert not dist.is_available() or not dist.is_initialized(), 'a process group'\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=120, check=True)
    assert out.stdout.strip() == "[]", out.stdout


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
                         + sorted((REPO / "examples").glob("*_torch.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_sources_import_no_jax_and_no_reference(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.name} imports {bad}"
