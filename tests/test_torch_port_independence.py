"""The port stands alone: no JAX and nothing of the JAX package.

Reads every module of ``src/repro_torch`` and ``chip_smoke.py`` for an
import of ``jax`` or ``repro``, and imports the launchers, the converters,
the LM stack, the train step, the mesh modules and the dry-run in a fresh
interpreter to show that neither lands in ``sys.modules``.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b(?!_)|"
    r"from\s+repro\b(?!_))", re.MULTILINE)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_neither_jax_nor_repro(path):
    hits = FORBIDDEN.findall(path.read_text())
    assert not hits, f"{path}: {hits}"


def test_forbidden_pattern_catches_what_it_should():
    for line in ("import jax", "from jax import numpy", "import repro",
                 "from repro.fvm.mesh import CavityMesh", "  import jax.numpy"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.fvm import mesh",
                 "import jaxlib_free", "# from repro. in a comment"):
        assert not FORBIDDEN.search(line), line


def test_launcher_import_loads_no_jax():
    code = ("import sys, repro_torch.launch.case, repro_torch.interop, "
            "repro_torch.models.lm, repro_torch.launch.serve, "
            "repro_torch.launch.train, repro_torch.training.train_step, "
            "repro_torch.launch.mesh, repro_torch.models.sharding, "
            "repro_torch.training.pipeline, "
            "repro_torch.serving.repartition_kv, "
            "repro_torch.launch.analysis, repro_torch.core.layout, "
            "repro_torch.launch.dryrun; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
