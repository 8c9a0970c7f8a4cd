"""Nothing the benchmark runs imports JAX or the JAX package, compared by whole
top-level module name; the reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

import run

BENCH_DIR = Path(__file__).resolve().parents[1]

FORBIDDEN = {"jax", "jaxlib", "flax", "diffsinger_tpu"}


def test_forbidden_modules_compares_whole_top_level_names():
    assert run.forbidden_modules(["diffsinger_tpu_torch", "diffsinger_tpu_torch.ops",
                                  "jax_like", "flaxen", "numpy"]) == []
    assert run.forbidden_modules(["diffsinger_tpu.models.fs2", "numpy"]) == ["diffsinger_tpu"]
    assert run.forbidden_modules(["jaxlib.xla_client", "flax", "jax"]) == ["flax", "jax",
                                                                           "jaxlib"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


SOURCES = sorted(p for p in BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=[str(p.relative_to(BENCH_DIR)) for p in SOURCES])
def test_no_source_imports_jax(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not set(_imports(path)) & (FORBIDDEN | {"diffsinger_tpu_torch", "benchmark"})
