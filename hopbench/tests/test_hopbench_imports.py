"""No module of the benchmark loads JAX or the JAX package, and the plain
reference takes nothing from the program under test.

Every .py file under hopbench/ (the metric readers, which are loaded by
path, and these tests included) is parsed, and each import's top-level name,
the part before the first dot, is compared whole.

    python -m pytest hopbench/tests/test_hopbench_imports.py -q
"""

import ast
from pathlib import Path

import pytest

HOPBENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "timeopt_tpu"}
MODULES = sorted(HOPBENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_every_module_is_found():
    rel = {p.relative_to(HOPBENCH).as_posix() for p in MODULES}
    assert {"run.py", "reference/check.py", "reference/systems.py", "tests/test_hopbench_imports.py"} <= rel
    assert any(r.startswith("metrics/") for r in rel)


@pytest.mark.parametrize("path", MODULES, ids=lambda p: p.relative_to(HOPBENCH).as_posix())
def test_no_module_imports_jax_or_the_jax_package(path):
    found = top_level_imports(path) & FORBIDDEN
    assert not found, f"{path} imports {sorted(found)}"


@pytest.mark.parametrize("path", sorted((HOPBENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.relative_to(HOPBENCH).as_posix())
def test_the_reference_imports_nothing_of_the_program(path):
    found = {n for n in top_level_imports(path) if n == "timeopt_tpu_torch"}
    assert not found, f"{path} imports the program under test"


def test_names_are_compared_whole(tmp_path):
    tmp = tmp_path / "probe.py"
    tmp.write_text("import timeopt_tpu_torch.models\nfrom jaxtyping import Array\nimport jax.numpy as jnp\n")
    names = top_level_imports(tmp)
    assert names & FORBIDDEN == {"jax"}
    assert "timeopt_tpu_torch" in names and "jaxtyping" in names
