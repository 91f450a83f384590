"""No module of the benchmark imports JAX or the JAX package; the
reference imports nothing of the program either; nothing reads the JAX
package's benchmarks.  Top-level names are compared whole: the port's
name begins with the JAX package's."""
import ast

import pytest

from conftest import ROOT

FILES = sorted((ROOT / "bench").rglob("*.py"))
JAX = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                    "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", FILES,
                         ids=[str(p.relative_to(ROOT)) for p in FILES])
def test_no_jax_import(path):
    assert not set(top_level_imports(path)) & JAX


@pytest.mark.parametrize("path", sorted((ROOT / "bench/reference")
                                        .glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(top_level_imports(path))


def test_jax_package_benchmarks_unread():
    for path in FILES:
        if path.name != "test_bench_imports.py":
            assert "benchmarks/" not in path.read_text(), path


def test_guard_compares_whole_names(monkeypatch):
    import sys

    from bench import harness
    import repro_torch  # noqa: F401  (the port: allowed)
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert "jax" in harness.forbidden_modules()
