"""The four-card cell rehearsed on the CPU: four gloo ranks run a tiny cut
of elf64k-anneal-4gpu (8 chains a rank, 16-iteration segments) through
the runner, one process a rank, as run.py runs the cell on four cards.
A sound run is correct with every rank in agreement; faults planted in
some ranks read not correct; a rank that fails ends the run with no
result, within the deadline, and leaves no process behind.

At this size a chain can stay unmoved through a 16-iteration segment
without any fault (its proposals all rejected; about one run in six at
32 chains), which `chains_unmoved` would count: the seed is
test_bench_faults.py's, on which every rank's chains move."""
import json
import os
import subprocess
import sys
import time

import pytest

from benchconf import BENCH, ROOT, tiny
from benchlib import check, runner

CELL = "elf64k-anneal-4gpu"
SEED = 2 ** 31 + 77
WORLD = 4
DEADLINE = 240.0


def _cut(**mix_update):
    spec, wl, conf, mix = tiny(CELL, chains=8 * WORLD)
    mix.update(mix_update)
    return spec, wl, conf, mix


def _parts(conf, mix, seconds=0.3, plants=(), deadline=DEADLINE):
    payload = {"conf": conf, "mix": mix, "seed": SEED, "seconds": seconds,
               "trace": False, "device_type": "cpu",
               "plants": [list(p) for p in plants]}
    return runner.rank_parts(payload, WORLD, deadline)


def _run(plants=(), conf_update=None, deadline=DEADLINE):
    spec, wl, conf, mix = _cut()
    conf["anneal"].update(conf_update or {})
    res, jax = runner.run_cell(spec, wl, conf, mix, SEED, 0.3, False,
                               time.time(), device_type="cpu",
                               plants=plants, deadline_s=deadline)
    assert not jax
    return res


def _values(res):
    return {k: v["value"] for k, v in res["checks"].items()}


def _rank_processes():
    """This process's children that run a rank."""
    out = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmd = f.read()
            with open(f"/proc/{pid}/stat") as f:
                ppid = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, IndexError, ValueError):
            continue
        if ppid == os.getpid() and b"rank_main" in cmd:
            out.append(int(pid))
    return out


def test_the_cell_asks_for_four_cards():
    _, wl, conf, _ = _cut()
    assert wl["chips"] == WORLD and conf["anneal"]["chains"] % WORLD == 0


def test_a_sound_run_is_correct_over_all_ranks():
    spec, wl, conf, mix = _cut()
    t0 = time.time()
    parts = _parts(conf, mix)
    assert len(parts) == WORLD
    assert len({p["units"] for p in parts}) == 1
    assert len({p["answer"] for p in parts}) == 1
    for p in parts:
        assert check.verdict(p["checks"]), p["checks"]
        assert p["checks"]["moves_gap"] == 0
        assert p["checks"]["exchange_gap"] == 0
        assert p["checks"]["capture_gap"] == 0
    # the rate counts the block's 32 chains, not the rank's 8
    p0 = parts[0]
    assert p0["e2e"]["moves_per_s"] * p0["obs"]["unit_wall_s"] == \
        pytest.approx(8 * WORLD)
    folded = runner.fold(spec, parts)
    assert folded["e2e"]["moves_per_s"] == min(
        p["e2e"]["moves_per_s"] for p in parts)
    assert folded["setup_end"] == max(p["setup_end"] for p in parts)
    res = runner.assemble(spec, wl, folded, False, t0)
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == WORLD
    assert _values(res)["ranks_disagree"] == 0
    assert _values(res)["chains_unmoved"] == 0
    assert set(res["metrics"]) == {"moves_per_s.4gpu", "out_bytes",
                                   "setup_s"}
    assert res["metrics"]["moves_per_s.4gpu"]["value"] == \
        folded["e2e"]["moves_per_s"]
    assert not _rank_processes()


@pytest.mark.parametrize("plant,rank", [("clock_fast", 1), ("clock_slow", 0)])
def test_ranks_stop_after_the_same_segment(plant, rank):
    """One rank's clock alone would close the window after the first
    segment (fast) or never (slow): the ranks agree after every segment,
    so each runs the same ones."""
    _, _, conf, mix = _cut(segment_iters=1)
    parts = _parts(conf, mix, seconds=2.0, plants=[(plant, [rank])])
    units = {p["units"] for p in parts}
    assert len(units) == 1
    if plant == "clock_fast":
        assert units == {1}
    assert len({p["answer"] for p in parts}) == 1
    for p in parts:
        assert p["checks"]["moves_gap"] == 0


@pytest.mark.parametrize("plant,ranks,number", [
    ("chains_stuck", [2], "chains_unmoved"),
    ("best_parse", [1], "ranks_disagree"),
    ("best_cost", None, "best_cost_gap"),
    ("step_skipped", None, "moves_gap"),
    ("half_chains", None, "chains_unmoved"),
    ("stream_byte", None, "decode_errors"),
])
def test_a_fault_in_some_ranks_is_not_correct(plant, ranks, number):
    res = _run(plants=[(plant, ranks)])
    v = _values(res)
    assert not res["correct"] and v[number] > 0, v
    if plant == "chains_stuck":
        assert v["chains_unmoved"] == 8          # rank 2's chains


def test_the_exchange_left_out_is_not_correct():
    """Each rank keeps the best of its own chains.  From the DP seed no
    chain of a short window beats the block's initial best, so the
    exchange has nothing to carry; from greedy parses the chains improve
    at once, and the ranks' bests part."""
    res = _run(plants=[("exchange_skipped", None)],
               conf_update={"init": "greedy"})
    v = _values(res)
    assert not res["correct"] and v["ranks_disagree"] > 0, v


@pytest.mark.parametrize("plant,number", [
    ("exchange_skipped", "exchange_gap"),
    ("capture_skipped", "capture_gap"),
])
def test_a_collective_left_out_is_not_correct(plant, number):
    """From the DP seed, as the cell runs, the ranks agree with no
    exchange and no capture all-reduce: the counts of both against the
    iterations run read every iteration left out."""
    spec, wl, conf, mix = _cut()
    res = _run(plants=[(plant, None)])
    v = _values(res)
    assert not res["correct"], v
    iters = mix["warmup_iters"] + mix["segment_iters"]
    assert v[number] >= iters and v[number] % mix["segment_iters"] == \
        mix["warmup_iters"], v
    other = ({"exchange_gap", "capture_gap"} - {number}).pop()
    assert v[other] == 0, v


def test_greedy_starts_agree_with_the_exchange():
    res = _run(conf_update={"init": "greedy"})
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("plant,rank", [("rank_raises", 1),
                                        ("rank_killed", 2)])
def test_a_rank_that_fails_ends_the_run(plant, rank):
    t0 = time.monotonic()
    with pytest.raises(runner.RankFailure, match=f"rank {rank} exited"):
        _run(plants=[(plant, [rank])])
    assert time.monotonic() - t0 < DEADLINE
    assert not _rank_processes()


def test_a_rank_that_hangs_is_killed_at_the_deadline():
    t0 = time.monotonic()
    with pytest.raises(runner.RankFailure, match="not done within"):
        _run(plants=[("rank_hangs", [3])], deadline=20.0)
    assert 20.0 <= time.monotonic() - t0 < 60.0
    assert not _rank_processes()


RUN_PY = """
import sys, time
sys.path[:0] = [%r, %r]
import torch
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 4
from benchconf import tiny
from benchlib import runner
real = runner.run_cell


def on_cpu(spec, wl, conf, mix, *a, **kw):
    spec, wl, conf, mix = tiny(wl["name"], chains=32)
    return real(spec, wl, conf, mix, *a, device_type="cpu",
                plants=%r, **kw)


runner.run_cell = on_cpu
import importlib.util
s = importlib.util.spec_from_file_location("run", %r)
run = importlib.util.module_from_spec(s)
s.loader.exec_module(run)
sys.exit(run.main(["--workload", %r, "--seed", "%d",
                   "--seconds", "0.3", "--trace", "0"]))
"""


@pytest.mark.parametrize("plants", [[], [["rank_raises", [1]]]],
                         ids=["sound", "rank_raises"])
def test_run_py_with_ranks(plants):
    """run.py over four ranks (its look for cards skipped, the cell cut
    as above): one result line when the ranks finish, none and a
    non-zero exit when one fails."""
    code = RUN_PY % (os.path.join(BENCH, "tests"), BENCH, plants,
                     os.path.join(BENCH, "run.py"), CELL, SEED)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    if plants:
        assert out.returncode != 0 and out.stdout == ""
        assert "rank 1 exited" in out.stderr
        return
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["count"] == WORLD
    assert list(res)[-1] == "checks"
    assert "check ranks_disagree = 0 (limit 0)" in out.stderr


def test_a_traced_run_over_ranks():
    """--trace 1: every rank runs the profiled stretch (the collectives
    need them all) after meeting the others; busy and window seconds
    are the ranks' mean, the breakdown rank 0's."""
    spec, wl, conf, mix = _cut()
    res, jax = runner.run_cell(spec, wl, conf, mix, SEED, 0.3, True,
                               time.time(), device_type="cpu",
                               deadline_s=DEADLINE)
    assert not jax and res["correct"], res["checks"]
    assert res["device"]["count"] == WORLD
    assert res["device"]["window_s"] > 0 and "busy_s" in res["device"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["metrics"]["host_ms_per_iter.4gpu"]["value"] > 0
