"""What the benchmark runs imports neither JAX nor the JAX package
(top-level names compared whole: ``kid_tpu_torch`` is not ``kid_tpu``),
and its reference imports nothing of the program."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "kid_tpu"}


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(BENCH)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


def test_the_names_are_compared_whole():
    assert "kid_tpu_torch".split(".")[0] not in FORBIDDEN
    assert any("kid_tpu_torch" in top_level_imports(p) for p in SOURCES)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    found = top_level_imports(path)
    assert not found & (FORBIDDEN | {"kid_tpu_torch", "kidbench"})
    assert found <= {"__future__", "math", "hashlib", "os", "pathlib",
                     "typing", "multiprocessing", "concurrent", "numpy",
                     "scipy", "torch"}


def test_run_refuses_a_process_that_loaded_jax(monkeypatch):
    import sys
    import types

    from kidbench import run
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "kid_tpu_torch_like", types.ModuleType(
        "y"))
    assert run.loaded_forbidden() == ["jaxlib"]
