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


SPEC = S.load(ROOT)
SEVERAL = [w["name"] for w in SPEC["workloads"] if w["chips"] > 1]
ANNEAL = [w["name"] for w in SPEC["workloads"]
          if S.traffic(w["traffic"])["kind"] == "anneal_block"]


@pytest.mark.parametrize("name", SEVERAL)
def test_a_cell_of_several_chips_splits_its_chains(spec, name):
    """The chains split evenly over the chain ranks, and chain_block is
    what the CLI resolves for that many chains."""
    from megalania_tpu_torch import cli
    wl = S.by_name(spec["workloads"], name)
    a = S.config(spec, wl["config"], ROOT)["anneal"]
    assert a["chains"] % wl["chips"] == 0
    assert a["chain_block"] == cli.chain_block(a["chains"], a["lc"])


def test_the_four_card_config_is_the_cli_defaults_at_512_chains(spec):
    four = S.config(spec, "elf-c512-4gpu", ROOT)
    one = S.config(spec, "elf-c128", ROOT)
    assert four["reduced"] == one["reduced"]
    assert {k: v for k, v in four["anneal"].items()
            if one["anneal"][k] != v} == {"chains": 512, "chain_block": 512}
    assert four["mesh"] == {"ranks": 4, "block_groups": 1, "chain_ranks": 4,
                            "chains_per_card": 128}


def test_the_four_card_mix_is_the_one_card_block():
    """The four-card cell anneals the same bytes from the same start as
    elf64k-anneal; only its segments follow its longer sweep."""
    one = S.traffic("libc64k-anneal")
    four = S.traffic("libc64k-anneal-sweep512")
    same = ("kind", "data", "sha256", "offset", "length", "warmup_iters",
            "check_chains")
    assert {k: four[k] for k in same} == {k: one[k] for k in same}


@pytest.mark.parametrize("name", ANNEAL)
def test_anneal_segments_are_whole_sweeps(spec, name):
    """Every segment of the window, and the profiled stretch, is a whole
    number of sweeps, so that every unit of the window does the same
    work and the profile reads a sweep's mean."""
    from megalania_tpu_torch.anneal import engine
    wl = S.by_name(spec["workloads"], name)
    a = S.config(spec, wl["config"], ROOT)["anneal"]
    mix = S.traffic(wl["traffic"])
    tile = engine.choose_tile(mix["length"], a["chain_block"], a["lc"])
    sweep = -(-mix["length"] // tile) * a["sweep_repeats"]
    assert mix["segment_iters"] % sweep == 0
    assert mix["profile_iters"] % sweep == 0


def test_the_four_card_cell_reports_the_anneal_metrics_and_the_exchange(
        spec):
    def names(cell, kind):
        return {m["name"].split(".")[0]
                for m in S.cell_metrics(spec, cell, kind)}
    assert names("elf64k-anneal-4gpu", "per_layer") == \
        names("elf64k-anneal", "per_layer") | {"nccl_ms_per_iter",
                                               "host_ms_per_iter"}
    assert names("elf64k-anneal-4gpu", "end_to_end") == \
        names("elf64k-anneal", "end_to_end")


def test_collective_metrics_only_in_cells_of_several_chips(spec):
    for m in spec["per_layer"]:
        if m["layer"] == "collective":
            for w in m["workloads"]:
                assert S.by_name(spec["workloads"], w)["chips"] > 1
