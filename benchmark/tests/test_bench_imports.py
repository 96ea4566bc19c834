"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the renderer or its tests."""

import ast
from pathlib import Path

BENCH = Path(__file__).resolve().parent.parent
NEVER = {"jax", "jaxlib", "flax", "rayn_tpu"}
NOT_IN_REFERENCE = NEVER | {"rayn_tpu_torch", "tests", "torch", "benchmark"}


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        assert not top_level_imports(f) & NEVER, f


def test_reference_imports_nothing_of_the_program():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert files
    for f in files:
        assert not top_level_imports(f) & NOT_IN_REFERENCE, f


def test_names_are_compared_whole():
    # the port's name begins with the JAX package's
    assert "rayn_tpu_torch".split(".", 1)[0] not in NEVER
