"""No module of the benchmark imports JAX, Flax or the JAX package (the
port's own name begins with the JAX package's, so top-level names are
compared whole), and the plain reference imports nothing of the program
under test."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "blindshadowremoval_tpu"}
PROGRAM = "blindshadowremoval_tpu_torch"
SOURCES = sorted(p for p in HERE.rglob("*.py") if "_work" not in p.parts)


def _top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not _top_level_imports(path) & FORBIDDEN


def test_whole_name_comparison():
    """The port's name passes; the JAX package's, alone or dotted, not."""
    from bench_h100.harness.device import forbidden_loaded

    assert forbidden_loaded({PROGRAM: 0, PROGRAM + ".ops": 0}) == []
    assert forbidden_loaded({"blindshadowremoval_tpu.ops": 0}) == [
        "blindshadowremoval_tpu"]
    assert forbidden_loaded({"jax._src": 0, "jaxlib": 0}) == ["jax", "jaxlib"]


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_stands_apart_from_the_program(path):
    imports = _top_level_imports(path)
    assert PROGRAM not in imports
    assert imports <= {"__future__", "numpy", "torch", "scipy", "bench_h100"}
    text = path.read_text()
    assert "bench_h100.harness" not in text   # reference -> reference only
