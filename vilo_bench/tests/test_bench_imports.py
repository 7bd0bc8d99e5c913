"""Nothing under vilo_bench/ imports JAX or the JAX package, and only the
entries (`entries/`, whose `Program` runs the program) import the program:
the harness, the reference, the generator, the trace reduction and the
metric readers import nothing of it. Top-level module names are compared
whole (`cerberus_tpu_torch` is not `cerberus_tpu`)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "cerberus_tpu"}
SOURCES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_and_the_program_only_in_the_harness(path):
    names = top_level_imports(path)
    assert not names & FORBIDDEN
    if "entries" not in path.relative_to(BENCH).parts:
        assert "cerberus_tpu_torch" not in names


def test_the_check_compares_whole_names():
    assert "cerberus_tpu_torch".split(".")[0] not in FORBIDDEN
    assert top_level_imports(BENCH / "harness.py") >= {"torch", "vilo_bench"}


def test_the_entries_do_not_import_the_loop_that_runs_them():
    for path in sorted((BENCH / "entries").glob("*.py")):
        names = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module == "vilo_bench":
                names |= {a.name for a in node.names}
            elif isinstance(node, (ast.Import, ast.ImportFrom)):
                names |= {m.split(".")[1] for m in
                          [getattr(node, "module", None) or ""]
                          + [a.name for a in node.names]
                          if m.startswith("vilo_bench.")}
        assert not names & {"harness", "run"}, path
