"""What the benchmark loads: no JAX and no JAX package anywhere, nothing of
the program in the reference, and none of the JAX package's benchmark."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "mpc_cbf_tpu"}


def imported_tops(path: Path):
    """Top-level names of every module a file imports (the part before the
    first dot, compared whole)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module" \
                and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def files(*dirs):
    return sorted(p for d in dirs for p in (ROOT / d).rglob("*.py"))


@pytest.mark.parametrize("folder", ["portbench", "mpc_cbf_torch"])
def test_no_jax_in_what_the_benchmark_loads(folder):
    """portbench/ and the program it drives (mpc_cbf_torch, whose name
    begins with the JAX package's and is a different top-level name)."""
    bad = {str(p.relative_to(ROOT)): sorted(set(imported_tops(p)) & FORBIDDEN)
           for p in files(folder)}
    assert not {k: v for k, v in bad.items() if v}


def test_reference_imports_nothing_of_the_program():
    for p in files("portbench/reference"):
        tops = set(imported_tops(p))
        assert "mpc_cbf_torch" not in tops and not tops & FORBIDDEN, p


def test_no_reading_of_the_jax_benchmark():
    for p in files("portbench"):
        text = p.read_text()
        if p.name == Path(__file__).name:
            continue
        for word in ("bench.py", "benchmarks/", "BENCH_"):
            assert word not in text, f"{p} names {word}"
