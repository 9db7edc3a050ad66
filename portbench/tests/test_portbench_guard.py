"""The import guard, and what the reference may import."""

import ast
import pathlib
import subprocess
import sys

from portbench.harness import cell, guard


def test_guard_compares_top_level_names_whole():
    assert guard.forbidden_modules(["jax", "jax.numpy", "jaxlib.xla",
                                    "flax", "madaiemulator_tpu.models"]) == [
        "flax", "jax", "jax.numpy", "jaxlib.xla", "madaiemulator_tpu.models"]
    assert guard.forbidden_modules(["madaiemulator_tpu_torch",
                                    "madaiemulator_tpu_torch.models.gp",
                                    "jaxtyping", "numpy"]) == []


def test_a_cell_loads_nothing_forbidden():
    """Import what a run imports, in a fresh interpreter."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench.harness import cell, guard\n"
        "import madaiemulator_tpu_torch.models.fit, "
        "madaiemulator_tpu_torch.parallel.ensemble\n"
        "for d in ('fit_loop', 'serve_loop'):\n"
        "    cell.load_module(cell.HERE / 'drivers' / (d + '.py'))\n"
        "for m in (cell.HERE / 'metrics').glob('*.py'):\n"
        "    cell.load_module(m)\n"
        "print(guard.forbidden_modules())\n" % str(cell.ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    for path in (cell.HERE / "reference").glob("*.py"):
        for name in _imports(path):
            top = name.split(".", 1)[0]
            assert top not in guard.FORBIDDEN + ("madaiemulator_tpu_torch",
                                                 "portbench"), (path, name)


def test_harness_imports_no_jax():
    for path in cell.HERE.rglob("*.py"):
        for name in _imports(path):
            assert name.split(".", 1)[0] not in guard.FORBIDDEN, (path, name)
