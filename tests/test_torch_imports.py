"""The PyTorch port imports neither JAX nor the JAX package: checked by
importing every module of ``unimm_torch`` (and chip_smoke.py) in a fresh
interpreter with both blocked, and by scanning their import statements."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_BLOCKED_IMPORT = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["unimm_tpu"] = None
import unimm_torch
names = ["unimm_torch"] + [m.name for m in pkgutil.walk_packages(
    unimm_torch.__path__, "unimm_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "unimm_tpu")
                and sys.modules[m] is not None)
assert not leaked, leaked
print(" ".join(names))
print(len(names))
"""

# the host data modules, the LMDB readers, the CLIs and the fixture writer
# of the evaluation and training command lines, among the modules imported
# above
_CLI_MODULES = {
    "unimm_torch.data.tokenizer", "unimm_torch.data.encoding",
    "unimm_torch.data.features", "unimm_torch.data.dataset",
    "unimm_torch.data.loader", "unimm_torch.native.lmdb",
    "unimm_torch.native.lmdb_format", "unimm_torch.cli.options",
    "unimm_torch.cli.common", "unimm_torch.cli.val_lm",
    "unimm_torch.cli.val_avg_lm", "unimm_torch.cli.val",
    "unimm_torch.cli.evaluate", "unimm_torch.tools.fixture_tree",
    # the training command line: its CLIs, logger and dense losses
    "unimm_torch.utils.logging", "unimm_torch.cli.train",
    "unimm_torch.cli.dense_finetune", "unimm_torch.ops.rank_loss",
    "unimm_torch.ops.focal_losses",
    # the data-parallel world across processes
    "unimm_torch.parallel", "unimm_torch.parallel.dist",
    # the VL task heads
    "unimm_torch.models.vl_tasks"}


def test_imports_with_jax_blocked():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    names, count = out.stdout.strip().splitlines()[-2:]
    assert int(count) >= 58
    assert _CLI_MODULES <= set(names.split()), _CLI_MODULES - set(
        names.split())


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_no_jax_import_statements():
    files = sorted((ROOT / "unimm_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py"]
    assert len(files) >= 58
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "unimm_tpu"}
        assert not bad, (f, bad)
