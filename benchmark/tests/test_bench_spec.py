"""BENCHMARK.json against the contract the harness relies on, and the
files it names, found by name."""
import json
import os
import shutil

import pytest

from benchconf import BENCH, ROOT, S

TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source",
                   "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}


@pytest.fixture
def spec():
    return S.load(ROOT)


def test_parses_with_the_contracts_keys(spec):
    assert set(spec) == TOP
    assert spec["command"] == ["python3", "benchmark/run.py"]
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    for section, keys in KEYS.items():
        for entry in spec[section]:
            assert set(entry) <= keys, (section, entry["name"])
    names = [m["name"] for m in spec["end_to_end"]]
    assert "setup_s" in names
    for m in spec["end_to_end"]:
        assert 0 < m["bound"] <= 0.25
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 << 10


def test_no_problems(spec):
    assert S.problems(spec, ROOT) == []


@pytest.mark.parametrize("name", [w["name"] for w in S.load(ROOT)[
    "workloads"]])
def test_each_cell_finds_its_files(spec, name):
    wl = S.by_name(spec["workloads"], name)
    conf = S.config(spec, wl["config"], ROOT)
    assert conf["name"] == wl["config"]
    mix = S.traffic(wl["traffic"])
    assert mix["name"] == wl["traffic"]
    for m in S.cell_metrics(spec, name, "per_layer"):
        assert callable(S.metric_reader(m["name"]))
    assert len(S.cell_metrics(spec, name, "end_to_end")) >= 2


def test_names_and_units(spec):
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in spec[section]:
            assert S.NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert S.UNIT.match(e["unit"]), e["unit"]
            for text in (e.get("why"), e.get("layer"), e.get("source")):
                if text is not None:
                    assert 1 <= len(text) <= 200 and "\n" not in text \
                        and "\t" not in text
    for w in spec["workloads"]:
        assert S.NAME.match(w["config"]) and S.NAME.match(w["traffic"])


@pytest.mark.parametrize("bad", ["a b", "a/b", "a,b", "", "x" * 65,
                                 "café"])
def test_name_rule_refuses(bad):
    assert not S.NAME.match(bad)


def test_per_layer_cells_report_what_they_move(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for m in spec["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in moved.get("workloads", [w]), (m["name"], w)


def test_one_four_chip_cell_at_most(spec):
    four = [w for w in spec["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(spec["workloads"]) // 4)


def test_added_files_are_found_without_edits(tmp_path, spec):
    """A new configuration, traffic mix and per-layer metric, dropped in
    as files with their entries, are found by name."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = root / "benchmark"
    conf = S.config(spec, "elf-c128", ROOT)
    conf["name"] = "elf-c64"
    conf["anneal"]["chains"] = 64
    (bench / "configs" / "elf-c64.json").write_text(json.dumps(conf))
    mix = S.traffic("libc64k-anneal")
    mix.pop("name")
    mix["length"] = 32768
    (bench / "traffic" / "libc32k-anneal.json").write_text(json.dumps(mix))
    (bench / "metrics" / "probe_count.py").write_text(
        "def read(obs):\n    return len(obs.get('probe', [])) or None\n")
    spec = json.loads(json.dumps(spec))
    spec["configs"].append({"name": "elf-c64", "source": "x",
                            "file": "benchmark/configs/elf-c64.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "elf32k-anneal", "config": "elf-c64",
                              "traffic": "libc32k-anneal", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("elf32k-anneal")
    spec["per_layer"].append({
        "name": "probe_count", "unit": "1", "better": "lower",
        "source": "program_counter", "layer": "kernels",
        "moves": "moves_per_s", "workloads": ["elf32k-anneal"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    assert S.problems(S.load(str(root)), str(root)) == []
    assert S.config(spec, "elf-c64", str(root))["anneal"]["chains"] == 64
    assert S.traffic("libc32k-anneal", str(bench))["length"] == 32768
    read = S.metric_reader("probe_count", str(bench))
    assert read({"probe": [1, 2]}) == 2 and read({}) is None
    names = [m["name"] for m in S.cell_metrics(spec, "elf32k-anneal",
                                               "per_layer")]
    assert names == ["probe_count"]
