"""megalania_tpu_torch stands alone: it builds from its own sources,
imports nothing of megalania_tpu and reads no file under it, and neither
do its scripts (the scale runners, the benchmarks, the profile tool,
chip_smoke) import jax or megalania_tpu; its entry points default to the
card."""
import ast
import importlib.util
import inspect
import os

import pytest
import torch.distributed as dist

from megalania_tpu_torch.anneal import engine
from megalania_tpu_torch.parallel import multihost
from megalania_tpu_torch.runtime import build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "megalania_tpu_torch")
REF = os.path.join(ROOT, "megalania_tpu")


def _port_modules():
    for d, _, files in os.walk(PORT):
        if "_build" in d:
            continue
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(d, f)
                with open(p) as fh:
                    yield os.path.relpath(p, ROOT), ast.parse(fh.read())


def _inside(path: str, root: str) -> bool:
    path, root = os.path.realpath(path), os.path.realpath(root)
    return os.path.commonpath([path, root]) == root


def test_build_sources_inside_the_port():
    """Every directory build.py reads or writes lies in the port."""
    dirs = {"CSRC": build.CSRC, "NATIVE_SRC": build.NATIVE_SRC,
            "BUILD_DIR": build.BUILD_DIR}
    for name, d in dirs.items():
        assert _inside(d, PORT), (name, d)
        assert not _inside(d, REF), (name, d)
    for name in ("optparse", "emitter"):
        assert os.path.isfile(os.path.join(build.NATIVE_SRC, f"{name}.cpp"))


def _code(src: bytes) -> list:
    """The source's lines with their // comments cut off."""
    return [line.split(b"//")[0].rstrip() for line in src.splitlines()]


@pytest.mark.parametrize("name", ["optparse", "emitter"])
def test_native_sources_are_the_references(name):
    """The host engines' code is the reference's, line for line, known
    defects included (ROADMAP queue 3); only comments may differ (the
    port's cite the upstream sources by project)."""
    with open(os.path.join(build.NATIVE_SRC, f"{name}.cpp"), "rb") as f:
        mine = f.read()
    with open(os.path.join(REF, "runtime", "native", f"{name}.cpp"),
              "rb") as f:
        assert _code(mine) == _code(f.read())


def test_no_module_reaches_into_the_reference():
    """No import of megalania_tpu and no path joined into its tree: a
    string "megalania_tpu" (or one starting "megalania_tpu/") may appear
    in a docstring or comment, never as an argument of a call."""
    def ref_name(s):
        return s == "megalania_tpu" or s.startswith("megalania_tpu/") \
            or s.startswith("megalania_tpu.")
    bad = []
    for rel, tree in _port_modules():
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                bad += [(rel, a.name) for a in node.names
                        if ref_name(a.name)]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                if node.module and ref_name(node.module):
                    bad.append((rel, node.module))
            elif isinstance(node, ast.Call):
                for arg in list(node.args) + [k.value for k in node.keywords]:
                    for sub in ast.walk(arg):
                        if isinstance(sub, ast.Constant) and isinstance(
                                sub.value, str) and ref_name(sub.value):
                            bad.append((rel, sub.value))
    assert not bad, bad


SCRIPTS = sorted(
    [os.path.join("tools", f) for f in os.listdir(os.path.join(ROOT, "tools"))
     if f.endswith("_torch.py")]
    + [os.path.join("tools", "profile_torch_iter.py"), "chip_smoke.py",
       "bench_torch.py"])


@pytest.mark.parametrize("rel", SCRIPTS)
def test_scripts_import_neither_jax_nor_the_reference(rel):
    """The port's scripts (the scale runners, the benchmarks, the profile
    tool, chip_smoke) import no jax and nothing of megalania_tpu, at any
    depth of their code."""
    def bad(name):
        return name and (name.split(".")[0] in ("jax", "jaxlib",
                                                "megalania_tpu"))
    with open(os.path.join(ROOT, rel)) as fh:
        tree = ast.parse(fh.read())
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if bad(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found += [node.module] if bad(node.module) else []
    assert not found, found


def test_runner_ports_exist():
    assert [s for s in SCRIPTS if s.startswith("tools/run_")] == [
        "tools/run_1mib_corpus_torch.py", "tools/run_4mib_corpus_torch.py",
        "tools/run_64k_block_torch.py"]


def _script(rel):
    name = os.path.splitext(os.path.basename(rel))[0]
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fn,param", [
    (multihost.initialize, "device"), (engine.context_from_numpy, "device"),
    (_script("bench_torch.py").measure, "device"),
    (_script(os.path.join("tools", "bench_corpus_torch.py")).run_ours,
     "device")])
def test_entry_points_default_to_the_card(fn, param):
    assert inspect.signature(fn).parameters[param].default == "cuda"


def test_initialize_without_torchrun_is_a_no_op(monkeypatch):
    """With the cuda default and no torchrun environment: rank 0, no
    process group, nothing touches a card."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() == 0
    assert not dist.is_initialized()
