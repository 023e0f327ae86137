"""Nothing a run imports is JAX, flax or the JAX package, compared by the
whole top-level name; the references import nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

from gnnbench.tests.conftest import ROOT

sys.path.insert(0, os.path.join(ROOT, "gnnbench"))
from run import FORBIDDEN, forbidden_modules  # noqa: E402


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_whole_top_level_names():
    assert forbidden_modules(["geot_tpu_torch", "geot_tpu_torch.ops.api", "jaxtyping",
                              "flaxen", "torch"]) == []
    assert forbidden_modules(["geot_tpu.ops", "jax._src.core", "jaxlib", "flax.linen"]) == [
        "flax", "geot_tpu", "jax", "jaxlib"]


def test_sources_import_nothing_forbidden():
    for path in glob.glob(os.path.join(ROOT, "gnnbench", "**", "*.py"), recursive=True):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(FORBIDDEN), path
        if os.sep + "reference" + os.sep in path:
            assert "geot_tpu_torch" not in tops, path


def test_a_run_loads_no_jax():
    """The harness, the program it drives and the references, imported and
    driven once on the CPU in a fresh process: sys.modules holds none of
    the forbidden names."""
    code = (
        "import sys; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "import torch\n"
        "from gnnbench.tests.conftest import make_checkout\n"
        "from gnnbench.harness.manifest import load_cell\n"
        "from gnnbench.harness.cell import run_cell\n"
        "import gnnbench.reference.gcn, gnnbench.reference.gat\n"
        "ref_only = {m.split('.')[0] for m in sys.modules}\n"
        "assert 'geot_tpu_torch' not in ref_only, 'the harness imported the program early'\n"
        "import tempfile, time\n"
        "root = make_checkout(tempfile.mkdtemp())\n"
        "run_cell(load_cell(root, 'tiny-ogbn-arxiv-gat.serve'), 7, 0.2, False,\n"
        "         torch.device('cpu'), time.perf_counter(), None)\n"
        "from run import forbidden_modules\n"
        "assert 'geot_tpu_torch' in {m.split('.')[0] for m in sys.modules}\n"
        "print(forbidden_modules(sys.modules))\n"
    ) % (ROOT, os.path.join(ROOT, "gnnbench"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
