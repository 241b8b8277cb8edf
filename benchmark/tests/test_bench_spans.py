"""The readers of the program's spans (benchlib/spans.py and the six
metrics that read it), on made-up profiled stretches (us)."""
import pytest

from benchconf import BENCH, S
from test_bench_imports import PROGRAM, top_imports

FILE_METRICS = {"index_ms_per_block": "context.index",
                "seed_candidates_ms_per_block": "seed.candidates",
                "seed_dp_ms_per_block": "seed.dp",
                "wait_ms_per_block": "block.wait"}
ALL = sorted(FILE_METRICS) + ["emit_ms_per_block.span",
                              "host_ms_per_iter.text"]

# a file of two blocks: each block's context and seed, its anneal, its
# waits and its emission; aten operations around and inside
FILE_HOST = [
    ("context.index", 0, 400), ("aten::empty", 10, 20),
    ("seed.candidates", 400, 3400), ("seed.dp", 3400, 4600),
    ("iter.draw", 4600, 4601), ("block.wait", 5000, 5100),
    ("block.wait", 5100, 5102), ("emit", 5110, 5200),
    ("context.index", 6000, 6600), ("seed.candidates", 6600, 9600),
    ("seed.dp", 9600, 10400), ("block.wait", 11000, 11300),
    ("block.wait", 11300, 11302), ("emit", 11310, 11420),
    ("aten::copy_", 11320, 11330)]

# three iterations, each tiled by the five stages
ITER_HOST = []
for i in range(3):
    t = 1000 * i
    for name, a, b in (("iter.draw", 0, 300), ("iter.cost", 300, 500),
                       ("iter.accept", 500, 650), ("iter.best", 650, 700),
                       ("iter.restart", 700, 720)):
        ITER_HOST.append((name, t + a, t + b))
    ITER_HOST.append(("aten::where", t + 510, t + 520))


def obs_of(scope, host, iters=1):
    return {"profile": {"scope": scope, "iters": iters, "wall_s": 1.0,
                        "dev": [("k", 0, 1)], "host": host, "t0": 0.0,
                        "t1": 1e6}}


def read(name, obs):
    return S.metric_reader(name)(obs)


@pytest.mark.parametrize("name", ALL)
def test_none_without_a_profile(name):
    assert read(name, {}) is None
    assert read(name, {"profile": None}) is None


@pytest.mark.parametrize("name", ALL)
def test_none_in_a_stretch_of_another_scope(name):
    other = "iterations" if name != "host_ms_per_iter.text" else "file"
    host = ITER_HOST if other == "iterations" else FILE_HOST
    assert read(name, obs_of(other, host, 3)) is None


@pytest.mark.parametrize("name", ALL)
def test_none_without_spans_of_its_name(name):
    scope = "iterations" if name == "host_ms_per_iter.text" else "file"
    # aten operations only: a program without spans
    host = [("aten::where", 0, 10), ("aten::add", 20, 30)]
    assert read(name, obs_of(scope, host, 3)) is None


@pytest.mark.parametrize("name", sorted(FILE_METRICS))
def test_none_without_a_block_emitted(name):
    host = [sp for sp in FILE_HOST if sp[0] != "emit"]
    assert read(name, obs_of("file", host)) is None


@pytest.mark.parametrize("name,want", [
    ("index_ms_per_block", (0.4 + 0.6) / 2),
    ("seed_candidates_ms_per_block", (3.0 + 3.0) / 2),
    ("seed_dp_ms_per_block", (1.2 + 0.8) / 2),
    ("wait_ms_per_block", (0.1 + 0.002 + 0.3 + 0.002) / 2),
    ("emit_ms_per_block.span", (0.09 + 0.11) / 2)])
def test_per_block_divides_by_the_emit_spans(name, want):
    assert read(name, obs_of("file", FILE_HOST)) == pytest.approx(want)


def test_a_third_emit_makes_three_blocks():
    host = FILE_HOST + [("emit", 20000, 20300)]
    assert read("index_ms_per_block", obs_of("file", host)) \
        == pytest.approx(1.0 / 3)
    assert read("emit_ms_per_block.span", obs_of("file", host)) \
        == pytest.approx((0.09 + 0.11 + 0.3) / 3)


def test_iteration_spans_summed_over_iters():
    # 0.72 ms of the five stages in each of three iterations; the aten
    # operation inside a stage is not counted twice
    obs = obs_of("iterations", ITER_HOST, 3)
    assert read("host_ms_per_iter.text", obs) == pytest.approx(0.72)
    obs["profile"]["iters"] = 6
    assert read("host_ms_per_iter.text", obs) == pytest.approx(0.36)


def test_iteration_spans_none_without_iters():
    assert read("host_ms_per_iter.text",
                obs_of("iterations", ITER_HOST, 0)) is None


def test_the_span_helper_imports_no_program():
    assert PROGRAM not in top_imports(f"{BENCH}/benchlib/spans.py")


def test_entries_read_program_spans():
    spec = S.load()
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in ALL:
        assert entries[name]["source"] == "program_span"
        assert entries[name]["unit"] == "ms"
    assert entries["host_ms_per_iter.text"]["workloads"] == ["text2k-anneal"]
    for name in ALL[:-1]:
        assert entries[name]["workloads"] == ["elf128k-file"]
