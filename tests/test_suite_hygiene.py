"""The suite's own rule: every ``slow`` test still runs in ``ci.sh``."""

import ast
import fnmatch
import glob
import os
import shlex

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)


def _is_mark_slow(node):
    """``pytest.mark.slow``, as a decorator, a call or a ``marks=`` value."""
    return (isinstance(node, ast.Attribute) and node.attr == "slow"
            and isinstance(node.value, ast.Attribute)
            and node.value.attr == "mark")


def _ci_pytest_args():
    """The arguments of each ``pytest`` command line of ``ci.sh``."""
    with open(os.path.join(REPO, "ci.sh")) as f:
        lines = [line.split("#")[0] for line in f]
    return [shlex.split(line) for line in lines if "pytest" in line]


def test_slow_tests_run_in_ci():
    """A file with a ``slow`` test is named by a ``pytest`` line of
    ``ci.sh`` that does not filter ``slow`` out; no file marks all of its
    tests ``slow``."""
    commands = _ci_pytest_args()
    for path in sorted(glob.glob(os.path.join(TESTS, "*.py"))):
        rel = os.path.relpath(path, REPO)
        with open(path) as f:
            source = f.read()
        if "slow" not in source:
            continue
        tree = ast.parse(source, filename=rel)
        for node in tree.body:
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "pytestmark"
                    for t in node.targets):
                assert not any(map(_is_mark_slow, ast.walk(node.value))), (
                    f"{rel} marks the whole module slow; mark its tests")
        if not any(map(_is_mark_slow, ast.walk(tree))):
            continue
        assert any(
            any(fnmatch.fnmatch(rel, arg) for arg in args)
            and not any("not slow" in arg for arg in args)
            for args in commands), f"ci.sh runs no test of {rel}"

