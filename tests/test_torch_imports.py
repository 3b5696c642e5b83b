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
print(len(names))
"""


def test_imports_with_jax_blocked():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 15


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
    assert len(files) >= 16
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "unimm_tpu"}
        assert not bad, (f, bad)
