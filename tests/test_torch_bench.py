"""The benchmark programs' ports (bench_torch.py,
tools/bench_corpus_torch.py, tools/ab_semantics_torch.py) on the CPU: at
tiny sizes each gives megalania_tpu's numbers for the same data and
configuration, the liblzma column gives BENCH_CORPUS.json's recorded
xz -9e sizes, and each refuses --device cuda without a card."""
import contextlib
import hashlib
import importlib.util
import io
import json
import os

import pytest
import torch

from megalania_tpu import compressor as JCM
from megalania_tpu.anneal import engine as JE
from megalania_tpu.anneal.config import AnnealConfig as JConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = os.path.join(ROOT, "tools", "corpus")


def _load(rel):
    name = os.path.splitext(os.path.basename(rel))[0]
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


BENCH = _load("bench.py")                    # the reference
BENCH_T = _load("bench_torch.py")
BC_T = _load(os.path.join("tools", "bench_corpus_torch.py"))
AB_T = _load(os.path.join("tools", "ab_semantics_torch.py"))

with open(os.path.join(ROOT, "BENCH_CORPUS.json")) as _f:
    RECORDED = json.load(_f)


def _read(path, n=None):
    with open(path, "rb") as f:
        return f.read()[:n]


def test_bench_data_is_survey_md():
    """bench.py reads SURVEY.md, its port the pinned snapshot."""
    assert _read(BENCH_T.DATA) == _read(os.path.join(ROOT, "SURVEY.md"))


@pytest.mark.parametrize("init,iters", [("mixed", 2), ("optimal", 2),
                                        ("mixed", 0)])
def test_measure_equals_bench_py(init, iters):
    """One row at n=256, 8 chains: the best after the warm-up and the
    timed window (iters=0: one sweep cycle each) equals bench.py's."""
    _, _, jbest, jiters = BENCH.measure(
        256, 8, iters, os.path.join(ROOT, "SURVEY.md"), init=init)
    got = BENCH_T.measure(256, 8, iters, init=init, device="cpu")
    assert got["best_bytes"] == jbest
    assert 18 + got["best_cost"] / 16384.0 == jbest
    assert got["iters"] == jiters and got["moves"] == 8 * jiters
    assert jiters == (iters or 4)         # one 256-position tile x 4


def test_bench_main(monkeypatch, capsys):
    """bench_torch.main's one JSON line at tiny rows: bench.py's keys and
    each row's best."""
    monkeypatch.setattr(BENCH_T, "N", 256)
    monkeypatch.setattr(BENCH_T, "N64K", 512)
    for k, v in (("BENCH_CHAINS", "8"), ("BENCH_CHAINS_64K", "8"),
                 ("BENCH_ITERS", "1"), ("BENCH_ITERS_64K", "1")):
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("BENCH_SKIP_64K", raising=False)
    monkeypatch.delenv("BENCH_PROPOSALS", raising=False)
    out = BENCH_T.main(["--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == out
    assert {"metric", "value", "unit", "vs_baseline", "best_bytes",
            "best_cost", "design_point_n65536"} <= set(out)
    dp = out["design_point_n65536"]
    assert {"moves_per_s", "vs_baseline", "converged_moves_per_s",
            "converged_vs_baseline", "best_bytes", "converged_best_bytes"
            } <= set(dp)
    assert out["device"] == "cpu" and out["unit"] == "moves/s"
    assert out["best_bytes"] == BENCH_T.measure(
        256, 8, 1, device="cpu")["best_bytes"]


def _overrides(init):
    """BENCH_CORPUS.json's recorded overrides (init=optimal) for the JAX
    package and the port (which has no kernel selector)."""
    jo = dict(RECORDED["overrides"], init=init)
    return jo, {k: v for k, v in jo.items() if k != "kernel"}


@pytest.mark.parametrize("name,init", [("survey.md", "optimal"),
                                       ("libc.so", "mixed")])
def test_run_ours_equals_the_reference(name, init):
    """bench_corpus_torch.run_ours against megalania_tpu's
    compressor.compress with the configuration bench_corpus.run_ours
    builds (8 chains: chain_block 128): the same stream."""
    data = _read(os.path.join(CORPUS, name), 256)
    jo, to = _overrides(init)
    want = JCM.compress(data, JConfig(chains=8, chain_block=128, **jo),
                        total_moves=64)
    got = BC_T.run_ours(data, 64, 8, to, device="cpu")
    assert got["sha256"] == hashlib.sha256(want).hexdigest()
    assert got["bytes"] == len(want) and got["decodes"]
    assert got["moves"] == 64


def test_bench_corpus_main(capsys):
    """One row per corpus file at a tiny size: the liblzma column, the
    recorded reference column only at the full budget, every stream
    decodes."""
    rep = BC_T.main(["--sizes", "128", "--chains", "8", "--budget-scale",
                     "0.0002", "--device", "cpu"])
    rows = [json.loads(line) for line in capsys.readouterr().out.split("\n")
            if line]
    assert rows == rep["rows"] and len(rows) == 4
    assert [r["file"] for r in rows] == [
        "survey.md", "pallas.md", "engine.py", "libc.so"]
    for r in rows:
        assert r["budget"] == int(3 * 200 * 128 * 0.0002)
        assert r["ours"]["decodes"] and "reference" not in r
        assert r["file_sha256"] == hashlib.sha256(
            _read(os.path.join(CORPUS, r["file"]))).hexdigest()


@pytest.mark.parametrize("row", RECORDED["rows"], ids=lambda r: r["file"])
def test_liblzma_column_is_recorded(row):
    """liblzma's preset 9 | extreme on each 2,048-byte cut gives the xz
    -9e size BENCH_CORPUS.json recorded, and the recorded reference
    column is the one the port reads."""
    data = _read(os.path.join(CORPUS, row["file"]), row["n"])
    assert BC_T.baselines(data)["liblzma_9e_bytes"] == row["xz9e"]["bytes"]
    assert BC_T.recorded_reference()[(row["file"], row["n"])] == (
        row["reference"])


def test_ab_semantics():
    """One line per corpus and variant and a WINS line; the packet-site
    variant's best equals megalania_tpu's engine on the same bytes."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        got = AB_T.main(["--n", "128", "--chains", "8", "--budget-scale",
                         "0.0003", "--device", "cpu"])
    lines = out.getvalue().splitlines()
    rows = [json.loads(line) for line in lines if line.startswith("{")]
    assert len(rows) == len(AB_T.CORPORA) * len(AB_T.VARIANTS) == 12
    assert lines[-1].startswith("WINS: ")
    assert all(r["n"] == 128 and r["moves"] == 16 for r in rows)
    var = {"site_mode": "packet"}
    cfg = JConfig(chains=8, chain_block=128, **var)
    ctx = JE.make_context(_read(os.path.join(CORPUS, "survey.md"), 128), cfg)
    st = JE.run_iters(JE.init_state(ctx, cfg), ctx, cfg, 2)
    assert got["survey.md"][json.dumps(var)] == JE.best_cost_bytes(st)


@pytest.mark.parametrize("main", [BENCH_T.main, BC_T.main, AB_T.main],
                         ids=["bench", "bench_corpus", "ab_semantics"])
def test_cuda_without_a_card_fails(monkeypatch, main):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        main([])
