"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level names; the reference imports nothing of the program."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "unimm_tpu"}


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def test_no_jax_anywhere():
    files = list(BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        bad = FORBIDDEN.intersection(_imports(f))
        assert not bad, f"{f}: {bad}"


def test_reference_imports_nothing_of_the_program():
    for f in (BENCH / "reference").rglob("*.py"):
        mods = set(_imports(f))
        assert not {m for m in mods if m.startswith("unimm")}, f
        assert mods <= {"__future__", "math", "torch"}, (f, mods)
