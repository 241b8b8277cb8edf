"""Blocks past 64 KiB at lc=3 on the CPU: matches that reach more than
65,536 bytes back, costs past 2**31, and the 1 MiB deployment's
configuration and data.

The plain reference is the benchmark's (benchmark/benchlib/reference.py:
a plain-Python LZMA-alone decoder and coster, independent of the port).
The port's side is its native DP seed, its emitter and its native exact
coster (optparse_native.cost_train), which run in seconds at this size;
the plain repair pass carries the cost totals past 2**31."""
import dataclasses
import hashlib
import json
import lzma
import os
import sys

import numpy as np
import pytest
import torch

from megalania_tpu_torch import cli, compressor
from megalania_tpu_torch.anneal import engine
from megalania_tpu_torch.anneal.config import AnnealConfig
from megalania_tpu_torch.match import optparse, optparse_native
from megalania_tpu_torch.models import packets as P
from megalania_tpu_torch.ops import problayout, repair_cuda
from megalania_tpu_torch.ops import tables as T
from megalania_tpu_torch.runtime import emit
from megalania_tpu_torch.utils import fixedpoint as fp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "benchmark"))
from benchlib import reference as R  # noqa: E402

CORPUS = os.path.join(ROOT, "tools", "corpus")
FAR = 65535                       # MATCH dist field = distance - 1


def far_block() -> bytes:
    """70,656 bytes: 4 KiB of prose, 61 KiB of an ELF, then the prose's
    sixteen 256-byte pieces out of order, so that each piece lies more
    than 64 KiB behind its copy and has to be coded by a far match."""
    text = open(os.path.join(CORPUS, "survey.md"), "rb").read()[:4096]
    elf = open(os.path.join(CORPUS, "libc.so"), "rb").read()
    order = [5, 12, 0, 9, 14, 3, 7, 1, 10, 15, 2, 8, 13, 4, 11, 6]
    return (text + elf[200000:200000 + 62464]
            + b"".join(text[k * 256:(k + 1) * 256] for k in order))


@pytest.fixture(scope="module")
def seeded():
    """The far block, its lc=3 DP seed (the port's native DP) and the
    stream the port emits from it."""
    data = far_block()
    cfg = AnnealConfig(lc=3, block_size=len(data))
    slab, dists = optparse.seed_slab(np.frombuffer(data, np.uint8), cfg)
    assert dists is None
    return data, slab, emit.emit(data, slab, dict_size=cfg.dict_size, lc=3)


def test_the_seed_codes_far_matches(seeded):
    data, slab, _ = seeded
    packets = R.parse_packed(slab)
    far = [p for p in packets if p.kind == R.MATCH and p.dist >= FAR]
    assert len(data) > 1 << 16 and len(far) >= 4
    # position slots 32 and up: 11 or more direct bits, 4 align bits
    assert max(p.dist for p in far) + 1 > 1 << 16


def test_the_stream_decodes_to_the_block(seeded):
    data, slab, stream = seeded
    dec = R.decode(stream)
    assert dec.data == data
    assert lzma.decompress(stream, format=lzma.FORMAT_ALONE) == data


def test_the_ports_exact_cost_is_the_references(seeded):
    data, slab, stream = seeded
    cost = optparse_native.cost_train(np.frombuffer(data, np.uint8), slab,
                                      lc=3)[0]
    assert cost == R.parse_cost(data, R.parse_packed(slab), lc=3)
    # the stream holds this parse: its decoded cost is the same number
    assert cost == R.decode(stream).cost


@pytest.mark.parametrize("total", [(1 << 31) - 1, 1 << 31, 7_100_000_000,
                                   (1 << 40) + 12345])
def test_fixedpoint_is_exact_past_2_31(total):
    """(hi, lo) sums of per-packet deltas (< 2**30) are the exact integer
    sum past 2**31, and compare and order as integers."""
    rng = np.random.default_rng(total % 1000)
    hi = lo = torch.zeros((), dtype=torch.int32)
    want = total
    while total:
        d = min(total, int(rng.integers(1, 1 << 30)))
        hi, lo = fp.accumulate(hi, lo, torch.tensor(d, dtype=torch.int32))
        total -= d
    assert fp.to_int(hi, lo) == want and 0 <= int(lo) <= fp.LO_MASK
    # order: one unit either side, and the lexicographic argmin
    below = divmod(want - 1, 1 << fp.LO_BITS)
    above = divmod(want + 1, 1 << fp.LO_BITS)
    his = torch.tensor([above[0], int(hi), below[0]], dtype=torch.int32)
    los = torch.tensor([above[1], int(lo), below[1]], dtype=torch.int32)
    assert bool(fp.less(his[2], los[2], hi, lo))
    assert not bool(fp.less(hi, lo, his[2], los[2]))
    assert bool(fp.less(hi, lo, his[0], los[0]))
    assert int(fp.argmin(his, los)) == 2


@pytest.mark.parametrize("offset", [(1 << 31) - 100, 7_100_000_000])
def test_repair_totals_pass_2_31_exactly(offset):
    """The plain repair pass adds a walk's cost to the snapshot's (hi, lo):
    from a snapshot whose total sits near or past 2**31 the result is the
    exact integer sum, normalised, and the engine's byte estimate reads
    it exactly."""
    data = far_block()[-384:]
    n = len(data)
    d32 = torch.tensor(np.frombuffer(data, np.uint8).astype(np.int32))
    slabs = P.from_u32(P.literal_slab(n)).expand(2, n).contiguous()
    dist = torch.zeros((n, 4), dtype=torch.int32)
    log2 = torch.tensor(T.LOG2_TABLE_I32)
    q = torch.zeros(2, dtype=torch.int32)
    fresh = torch.full((2, problayout.get_layout(3).PACKED_ROWS),
                       T.PROB_INIT, dtype=torch.int32)

    def walk(carry):
        return repair_cuda.repair_cost_plain(
            slabs, q, q, d32, dist, dist, log2, lc=3, start_pos=0,
            probs_in=fresh, carry_in=carry)
    base = walk(torch.zeros((2, 16), dtype=torch.int32))
    cost = fp.to_int(base[1][0], base[2][0])
    carry = torch.zeros((2, 16), dtype=torch.int32)
    carry[:, 6], carry[:, 7] = divmod(offset, 1 << fp.LO_BITS)
    got = walk(carry)
    for c in range(2):
        assert fp.to_int(got[1][c], got[2][c]) == offset + cost
        assert 0 <= int(got[2][c]) <= fp.LO_MASK
    state = engine.AnnealState(*([None] * 11))._replace(
        best_hi=got[1][0], best_lo=got[2][0])
    assert engine.best_cost_bytes(state) == 18 + (offset + cost) / 16384.0


def test_the_1m_config_is_the_clis_resolution(tmp_path, monkeypatch):
    """benchmark/configs/elf1m-lc3.json's anneal keys are what
    `compress FILE --block-size 1048576 --lc 3` runs with (its seed is
    the run's --seed)."""
    conf = json.load(open(os.path.join(ROOT, "benchmark", "configs",
                                       "elf1m-lc3.json")))
    seen = {}

    def capture(data, cfg, **kw):
        seen["cfg"] = cfg
        return b""
    monkeypatch.setattr(compressor, "compress", capture)
    path = tmp_path / "in.bin"
    path.write_bytes(b"x")
    cli.main(["compress", str(path), "--block-size", "1048576", "--lc", "3",
              "--device", "cpu", "--quiet", "-o", str(tmp_path / "o")])
    got = seen["cfg"]
    assert got == AnnealConfig(**conf["anneal"], seed=got.seed)
    assert got.seed == AnnealConfig().seed
    assert (conf["anneal"]["block_size"], conf["anneal"]["lc"]) == (
        P.MAX_BLOCK, 3)
    assert conf["anneal"]["chain_block"] == cli.chain_block(128, 3)
    base = json.load(open(os.path.join(ROOT, "benchmark", "configs",
                                       "elf-c128.json")))
    changed = {k for k, v in conf["anneal"].items()
               if base["anneal"][k] != v}
    assert changed == {"block_size", "lc"}
    assert dataclasses.asdict(got)["pb"] == 0


def test_the_1m_data_is_perf_1mibs_corpus():
    raw = open(os.path.join(ROOT, "benchmark", "data", "libc.so-1m"),
               "rb").read()
    rec = json.load(open(os.path.join(ROOT, "PERF_1MIB.json")))
    assert len(raw) == rec["corpus_bytes"] == P.MAX_BLOCK
    assert hashlib.sha256(raw).hexdigest() == rec["corpus_sha256"]
    assert raw == open(os.path.join(CORPUS, "libc.so"),
                       "rb").read()[:P.MAX_BLOCK]
