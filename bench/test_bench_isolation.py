"""Nothing under bench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program either: top-level module names
compared whole (``repro_torch`` begins with ``repro`` and is another
name)."""
import ast
import pathlib

import pytest

BENCH = pathlib.Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_bench_imports_neither_jax_nor_the_jax_package(path):
    bad = sorted(set(_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(BENCH)} imports {bad}"


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").rglob("*.py")),
    ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    roots = set(_roots(path))
    assert "repro_torch" not in roots, f"{path.name} imports the program"
    assert roots <= {"__future__", "dataclasses", "math", "typing",
                     "numpy", "torch", "bench"}, roots
    # within the benchmark, only the reference itself
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("bench"):
            assert node.module.startswith("bench.reference"), node.module


def test_every_module_is_scanned():
    names = {p.relative_to(BENCH).as_posix() for p in FILES}
    assert {"run.py", "control.py", "harness/serve.py",
            "reference/speca.py", "reference/dit.py"} <= names
