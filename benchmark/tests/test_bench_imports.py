"""Nothing of the benchmark imports the JAX stack or the JAX package
(top-level names compared whole: megalania_tpu_torch begins with
megalania_tpu), and the reference and the yardsticks import nothing of
the program either."""
import ast
import glob
import os
import subprocess
import sys

import pytest

from benchconf import BENCH

JAX = {"jax", "jaxlib", "flax", "megalania_tpu"}
PROGRAM = "megalania_tpu_torch"
# the yardsticks: everything but the drivers that run the program
PURE = ["benchlib/reference.py", "benchlib/check.py", "benchlib/window.py",
        "benchlib/roofline.py", "benchlib/devtrace.py", "benchlib/spec.py",
        "benchlib/traffic.py", "benchlib/__init__.py"] + [
    os.path.relpath(p, BENCH)
    for p in glob.glob(os.path.join(BENCH, "metrics", "*.py"))]


def top_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def all_sources():
    return sorted(glob.glob(os.path.join(BENCH, "**", "*.py"),
                            recursive=True))


@pytest.mark.parametrize("path", all_sources(),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_anywhere(path):
    assert not top_imports(path) & JAX


@pytest.mark.parametrize("rel", PURE)
def test_reference_and_yardsticks_import_no_program(rel):
    assert PROGRAM not in top_imports(os.path.join(BENCH, rel))


def test_whole_name_rule():
    assert "megalania_tpu_torch".split(".")[0] not in JAX
    assert "megalania_tpu.ops".split(".")[0] in JAX


def test_a_drivers_process_holds_no_jax():
    """Import everything a run imports, the program included, in a fresh
    process: no module of the JAX stack or package appears."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from benchlib import runner, cells, reference\n"
            "import megalania_tpu_torch.compressor, "
            "megalania_tpu_torch.parallel.mesh\n"
            "print(','.join(cells.forbidden_modules()))"
            % (BENCH, os.path.dirname(BENCH)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip() == ""
