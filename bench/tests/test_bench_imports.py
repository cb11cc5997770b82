"""What the benchmark's files import, by whole top-level module name:
nothing of JAX or the JAX package (``repro``; ``repro_torch`` only begins
with that name), and the references nothing of the program either."""
import ast
from pathlib import Path

import pytest

import _bench_tiny

BENCH = _bench_tiny.BENCH
FILES = sorted(BENCH.rglob("*.py"))
JAX = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_scan_compares_whole_names(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import repro_torch.models\nfrom reprox import y\n"
                 "import jax.numpy as jnp\nfrom . import z\n")
    names = top_level_imports(p)
    assert names == {"repro_torch", "reprox", "jax"}
    assert names & JAX == {"jax"}


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert top_level_imports(path) <= {"__future__", "typing", "math",
                                       "contextlib", "torch", "reference"}
