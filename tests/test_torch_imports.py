"""The port stands alone: no module of geot_tpu_torch, and not
chip_smoke.py, imports JAX, flax, optax or the JAX package (the machine
with the card has none of them)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "optax", "geot_tpu"}
FILES = sorted((ROOT / "geot_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_files_found():
    assert (ROOT / "chip_smoke.py").exists()
    assert len(FILES) > 10


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = sorted(set(_imported_roots(path)) & BANNED)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"
