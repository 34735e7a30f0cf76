"""Nothing under bench/ imports JAX or the JAX package (top-level names
compared whole: ``repro_torch`` is not ``repro``), and the plain
reference imports nothing of the program."""
import ast

import pytest

from bench.tests.tiny import ROOT
from bench import harness

FILES = sorted((ROOT / "bench").rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "bench" / "reference").glob("*.py"):
        assert "repro_torch" not in top_level_imports(path)


def test_forbidden_modules_compares_whole_names():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.deploy",
                                      "jaxtyping", "flaxen"]) == []
    assert harness.forbidden_modules(["repro.core", "jax._src",
                                      "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "repro"]
