"""What the benchmark's files may import and read: no JAX and no JAX
package anywhere under ``perfbench/`` (top-level names compared whole:
the port's ``repro_torch`` begins with ``repro``), nothing of the program
in the references, and nothing of the JAX package's benchmarks or the
port's smoke script at run time."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(HERE.rglob("*.py"))
BANNED = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path) -> set:
    """Top-level names of every absolute import in ``path``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def strings(path: Path) -> list:
    """String constants of ``path`` that are not docstrings."""
    tree = ast.parse(path.read_text())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef))
            and n.body and isinstance(n.body[0], ast.Expr)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & BANNED


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert imported(path) <= {"__future__", "dataclasses", "math", "time",
                              "torch"}


def test_the_walk_compares_whole_names(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import repro_torch.models\nfrom reprox import y\n"
                 "from . import z\n")
    assert imported(f) == {"repro_torch", "reprox"}
    f.write_text("import repro.core\n")
    assert imported(f) & BANNED == {"repro"}


def test_nothing_reads_the_jax_benchmarks_or_the_smoke_script():
    for path in FILES:
        if path.parent.name == "tests":
            continue
        for s in strings(path):
            assert not any(x in s for x in ("BENCH_", "chip_smoke",
                                            "benchmarks")), (path, s)
