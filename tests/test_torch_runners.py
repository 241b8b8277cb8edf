"""The scale runners' ports (tools/run_*_torch.py) on the CPU: their
corpora are the recorded ones where a record exists, and at a tiny size
each gives megalania_tpu's bytes for the same data and configuration,
decodes, and refuses --device cuda without a card."""
import hashlib
import importlib.util
import lzma
import os

import pytest
import torch

from megalania_tpu import compressor as JCM
from megalania_tpu.anneal.config import AnnealConfig as JConfig
from megalania_tpu_torch import compressor as TCM

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _runner(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


R64K = _runner("run_64k_block_torch")
R1M = _runner("run_1mib_corpus_torch")
R4M = _runner("run_4mib_corpus_torch")


def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def test_corpus_hashes():
    # the reference runners' corpora (PERF_1MIB.json; the 64 KiB runner's
    # SURVEY.md + Pallas guide) and the in-repo 4 MiB corpus
    assert _sha(R1M.corpus()) == R1M.SHA256_1MIB == (
        "36432546d5f0133325d669fb760d58095df616e6e07bda5feb842490156b8db6")
    assert _sha(R64K.corpus(1 << 16)) == (
        "14b7b61825f14bc0fb06a2d38ef18b511a29b090a540b8e6c43d38a8e290c91a")
    assert _sha(R4M.corpus()) == (
        "1f0748dcd0b494eb03e3bf1b1f4f099ca30b6f041b79f6b9e3d08c6d41747ce2")
    assert R4M.corpus(1 << 20) == R1M.corpus()


def test_64k_runner(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("RUN64K_N", "256")
    monkeypatch.delenv("RUN64K_CKPT", raising=False)
    out = tmp_path / "out.lzma"
    got = R64K.main(["16", "8", "--device", "cpu", "-o", str(out)])
    data = R64K.corpus(256)
    want = JCM.compress_block(data, JConfig(
        chains=8, chain_block=128, block_size=256, init="mixed",
        accept="cooled"), total_moves=16)
    assert out.read_bytes() == want.stream
    assert got["bytes"] == len(want.stream) and got["decode_ok"]
    assert got["predicted"] == want.predicted_bytes
    assert got["moves"] == 16 and got["device"] == "cpu"
    assert lzma.decompress(want.stream, format=lzma.FORMAT_ALONE) == data
    assert '"decode_ok": true' in capsys.readouterr().out


def test_1mib_runner(tmp_path):
    out = tmp_path / "out.mlz"
    n = 4 * 512 + 300
    got = R1M.main(["16", "8", "--device", "cpu", "-o", str(out)],
                   corpus_bytes=n, block_size=512)
    data = R1M.corpus(n)
    want = JCM.compress(data, JConfig(chains=8, block_size=512),
                        total_moves=16 * 5, use_mesh=False)
    assert out.read_bytes() == want
    assert TCM.decompress(want) == data
    assert got["blocks"] == 5 and len(got["per_block"]) == 5
    assert got["bytes"] == len(want) and got["decode_ok"]
    assert [b["moves"] for b in got["per_block"]] == [16] * 5


def test_4mib_runner(tmp_path):
    out = tmp_path / "out.mlz"
    got = R4M.main(["0", "3", "16384", "65536", "--device", "cpu",
                    "-o", str(out)])
    data = R4M.corpus(65536)
    want = JCM.compress(data, JConfig(chains=128, block_size=16384, lc=3,
                                      init="optimal", accept="greedy"),
                        total_moves=0, use_mesh=False)
    assert out.read_bytes() == want
    assert got["bytes"] == len(want) and got["decode_ok"]
    assert got["blocks"] == 4 and got["pipeline"] == "dp_only"
    assert got["corpus"].startswith("in-repo")


@pytest.mark.parametrize("runner,argv", [
    (R64K, []), (R1M, []), (R4M, ["0", "3", "16384", "65536"])])
def test_cuda_without_a_card_fails(monkeypatch, runner, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        runner.main(argv)
