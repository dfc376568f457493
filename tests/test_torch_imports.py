"""The port stands alone: nothing in ``src/repro_torch``, the port's
examples (``examples/torch_*.py``) or ``chip_smoke.py`` imports ``jax``
or the JAX package ``repro``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
PORT = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
EXAMPLES = sorted((REPO / "examples").glob("torch_*.py"))
SOURCES = PORT + EXAMPLES + [REPO / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_or_repro_import(path):
    bad = _imported_roots(path) & {"jax", "jaxlib", "repro"}
    assert not bad, f"{path.relative_to(REPO)} imports {sorted(bad)}"


def test_port_sources_found():
    names = {p.relative_to(REPO / "src").as_posix() for p in PORT}
    assert "repro_torch/serving/engine.py" in names
    assert "repro_torch/kernels/flash_attention.py" in names
    assert "repro_torch/train/step.py" in names
    for mod in ("hw/tpu", "hw/dvfs", "hw/flops", "hw/h100", "core/tasks",
                "core/power_model", "core/metrics", "core/trace",
                "power/metrics", "power/backends", "power/manager",
                "power/arbiter", "power/nvml", "power/metered",
                "train/phases", "models/lsms"):
        assert f"repro_torch/{mod}.py" in names
    assert {p.name for p in EXAMPLES} == {
        "torch_lsms_scf.py", "torch_quickstart.py", "torch_serve_decode.py",
        "torch_train_energy_aware.py"}
    assert (REPO / "chip_smoke.py").exists()


def test_importing_the_engine_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    code = ("import sys, repro_torch.serving.engine, "
            "repro_torch.launch.serve, repro_torch.launch.train, "
            "repro_torch.power.nvml, repro_torch.power.metered, "
            "repro_torch.models.lsms, repro_torch.hw, repro_torch.core; "
            "bad = [m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'repro')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
