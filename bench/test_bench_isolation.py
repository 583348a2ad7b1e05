"""Nothing of the benchmark imports JAX or the JAX package (top-level
names compared whole: the port's ``repro_torch`` begins with ``repro``),
nothing reads the JAX package's benchmark folder, and a run's result
line is refused when such a module was loaded."""

import ast

import pytest

from bench.lib import common

SOURCES = sorted(common.BENCH.rglob("*.py"))
JAX_BENCHMARKS = "bench" + "marks"


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_no_jax_import(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        assert not common.forbidden_modules(names), (path, names)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.name)
def test_nothing_reads_the_jax_benchmark_folder(path):
    assert JAX_BENCHMARKS not in path.read_text()


def test_forbidden_names_are_compared_whole():
    got = common.forbidden_modules(["repro_torch", "repro_torch.core",
                                    "repro", "repro.core", "jax.numpy",
                                    "jaxlib", "flax", "jaxtyping",
                                    "reprox"])
    assert got == ["flax", "jax.numpy", "jaxlib", "repro", "repro.core"]
