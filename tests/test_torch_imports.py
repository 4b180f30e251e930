"""The port stands alone: no module of repro_torch, nor chip_smoke.py, imports
jax or the JAX package ``repro`` (its jax-free modules included).  Only the
port's tests import both."""
import ast
from pathlib import Path

import pytest

from torch_threads import torch_threads  # noqa: F401  (autouse: torch's threads a worker)

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_files_found():
    names = {p.name for p in FILES}
    assert {"__init__.py", "ops.py", "resnet.py", "chip_smoke.py", "optimizer.py", "data.py",
            "checkpoint.py", "loop.py", "train.py", "tree.py", "mamba_scan.py",
            "ssm.py", "blocks.py", "autotune.py", "costmodel.py", "mesh.py"} <= names
    assert len(FILES) >= 15


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported_modules(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_catches_forbidden_imports():
    src = "import jax.numpy as jnp\nfrom repro.core import epitome\nfrom .x import y\nimport repro_torch\n"
    assert [m for m in _imported_modules(ast.parse(src))
            if m.split(".")[0] in FORBIDDEN] == ["jax.numpy", "repro.core"]
