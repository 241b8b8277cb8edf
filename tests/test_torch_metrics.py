"""megalania_tpu_torch.utils.metrics and .profiling on the CPU: per-segment
JSONL records from compress_block, step timing, named spans and a
written trace."""
import io
import json
import os

import torch

from megalania_tpu_torch import compressor
from megalania_tpu_torch.anneal.config import AnnealConfig
from megalania_tpu_torch.utils import profiling
from megalania_tpu_torch.utils.metrics import MetricsLogger, stderr_logger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = open(os.path.join(ROOT, "tools", "corpus", "libc.so"),
            "rb").read()[4096:4096 + 160]
CFG = AnnealConfig(chains=8, max_candidates=8, max_walk=48, top_k=12)


def test_metrics_jsonl(tmp_path):
    path = str(tmp_path / "m.jsonl")
    m = MetricsLogger(jsonl_path=path)
    compressor.compress_block(DATA, CFG, total_moves=8 * 8, segment_iters=4,
                              metrics=m, device="cpu")
    recs = [json.loads(line) for line in open(path)]
    assert len(recs) == 2 and recs == m.history
    assert all("best_bytes" in r and "moves" in r for r in recs)
    assert [r["iter"] for r in recs] == [4, 8]
    assert recs[-1]["iter"] == recs[-1]["iters"]
    assert recs[-1]["moves"] == 64


def test_stderr_logger_lines(monkeypatch):
    buf = io.StringIO()
    monkeypatch.setattr("sys.stderr", buf)
    stderr_logger().log(block=0, moves=5)
    assert buf.getvalue().startswith("block=0  moves=5  t=")


def test_step_timer_and_annotate():
    m = MetricsLogger()
    with profiling.step_timer("matmul", sink=m) as holder:
        with profiling.span("region"):
            x = torch.ones(64, 64)
            holder["result"] = (x @ x, x)
    assert holder["seconds"] > 0
    assert m.history[0]["name"] == "matmul"
    assert m.history[0]["seconds"] >= 0


def test_trace_writes_chrome_trace(tmp_path):
    d = str(tmp_path / "trace")
    with profiling.trace(d) as prof:
        with profiling.span("meg_region"):
            torch.ones(32).cumsum(0)
    path = os.path.join(d, "trace.json")
    assert os.path.getsize(path) > 0
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "meg_region" in names
    assert any(e.key == "meg_region" for e in prof.key_averages())
