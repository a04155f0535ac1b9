"""The layout of the suite: the gaussian-sharded cases stay in the run.

The nine cases of tests/test_gauss_sharded.py compile 8-device programs
for minutes; the repository's root conftest.py starts that file first
under ``--dist loadfile``. This reads the files with ``ast`` and runs
nothing of them.
"""

import ast
from functools import cache
from pathlib import Path

import pytest

TESTS = Path(__file__).parent
GAUSS_SHARDED_CASES = (
    "test_gauss_sharded_render_matches_single_device",
    "test_gauss_sharded_render_sh_degrees",
    "test_gauss_sharded_grads_match_replicated",
    "test_gauss_sharded_train_step_matches_unsharded",
    "test_gauss_sharded_adam_moments_sharded_step",
    "test_gauss_sharded_pallas_receiver",
    "test_gauss_sharded_route_overflow_counted",
    "test_gauss_sharded_height_divisibility_error",
    "test_gauss_sharded_trains_through_route_overflow",
)
LEAVE_THE_RUN = ("slow", "skip", "skipif", "xfail")


def long_files() -> tuple:
    """The root conftest.py's LONG_FILES, read without importing it."""
    tree = ast.parse((TESTS.parent / "conftest.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "LONG_FILES" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("conftest.py defines no LONG_FILES")


def marks(node) -> set:
    """The names of the marks in ``pytest.mark.<name>`` under ``node``."""
    return {n.attr for n in ast.walk(node)
            if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Attribute)
            and n.value.attr == "mark"}


@cache
def definitions() -> dict:
    """Each module-level test function's name: [(file, its decorators' and
    the module's ``pytestmark`` marks)]."""
    found = {}
    for path in sorted(TESTS.glob("*.py")):
        tree = ast.parse(path.read_text())
        module_marks = set().union(*(
            marks(n) for n in tree.body if isinstance(n, ast.Assign)
            and any(isinstance(t, ast.Name) and t.id == "pytestmark" for t in n.targets)))
        for node in tree.body:
            if isinstance(node, ast.FunctionDef) and node.name.startswith("test_"):
                got = set().union(module_marks, *(marks(d) for d in node.decorator_list))
                found.setdefault(node.name, []).append((path.name, got))
    return found


@pytest.mark.parametrize("name", GAUSS_SHARDED_CASES)
def test_gauss_sharded_case_defined_once_and_unmarked(name):
    defs = definitions().get(name, [])
    assert len(defs) == 1, f"{name} is defined {len(defs)} times under tests/: {defs}"
    path, got = defs[0]
    assert path == "test_gauss_sharded.py", path
    assert not got & set(LEAVE_THE_RUN), f"{name} in {path} is marked {got}"


def test_long_files_exist():
    """conftest.py starts these files first; a renamed one would drop out
    of that order without an error."""
    assert "tests/test_gauss_sharded.py" in long_files()
    for name in long_files():
        assert (TESTS.parent / name).is_file(), name
