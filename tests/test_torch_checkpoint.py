"""Checkpoint/resume of megalania_tpu_torch through compress_block and
the CLI, against megalania_tpu: an interrupted run resumes to the
uninterrupted bytes, within the port and across the two packages in
both directions (the npz layout is shared)."""
import json
import lzma
import os

import numpy as np
import pytest

from megalania_tpu import compressor as JCM
from megalania_tpu.anneal.config import AnnealConfig as JConfig
from megalania_tpu_torch import cli, compressor as TCM
from megalania_tpu_torch.anneal import engine as TE
from megalania_tpu_torch.anneal.config import AnnealConfig as TConfig
from megalania_tpu_torch.utils import checkpoint as TCK

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIBC = open(os.path.join(ROOT, "tools", "corpus", "libc.so"), "rb").read()
DATA = LIBC[12288:12288 + 192]
KW = dict(chains=8, max_candidates=8, max_walk=48, top_k=12)
MOVES = 8 * 40                      # 40 iterations at 8 chains
SEG = 10


class Interrupt(Exception):
    pass


def _kill(info):
    raise Interrupt


def _interrupted(cm, cfg, ck, after, **kw):
    """Run cm.compress_block until `after` segments are done, each
    checkpointed, then raise out of it as a kill would."""
    seen = {"n": 0}

    def bomb(info):
        seen["n"] += 1
        if seen["n"] == after:
            raise Interrupt

    with pytest.raises(Interrupt):
        cm.compress_block(DATA, cfg, total_moves=kw.pop("moves", MOVES),
                          segment_iters=SEG, checkpoint_path=ck,
                          checkpoint_every=1, progress=bomb, **kw)
    assert os.path.exists(ck)


@pytest.fixture(scope="module")
def straight():
    """The reference's uninterrupted bytes (the port's equal them)."""
    want = JCM.compress_block(DATA, JConfig(**KW), total_moves=MOVES,
                              segment_iters=SEG).stream
    got = TCM.compress_block(DATA, TConfig(**KW), total_moves=MOVES,
                             segment_iters=SEG, device="cpu").stream
    assert got == want
    return want


def test_resume_bit_identical(straight, tmp_path):
    ck = str(tmp_path / "blk.npz")
    _interrupted(TCM, TConfig(**KW), ck, 2, device="cpu")
    res = TCM.compress_block(DATA, TConfig(**KW), total_moves=MOVES,
                             segment_iters=SEG, checkpoint_path=ck,
                             resume=True, device="cpu")
    assert res.stream == straight
    assert res.moves == MOVES
    assert lzma.decompress(res.stream, format=lzma.FORMAT_ALONE) == DATA


def test_reference_checkpoint_resumes_in_port(straight, tmp_path):
    ck = str(tmp_path / "ref.npz")
    _interrupted(JCM, JConfig(**KW), ck, 2)
    res = TCM.compress_block(DATA, TConfig(**KW), total_moves=MOVES,
                             segment_iters=SEG, checkpoint_path=ck,
                             resume=True, device="cpu")
    assert res.stream == straight
    assert res.moves == MOVES


def test_port_checkpoint_resumes_in_reference(straight, tmp_path):
    ck = str(tmp_path / "port.npz")
    _interrupted(TCM, TConfig(**KW), ck, 2, device="cpu")
    res = JCM.compress_block(DATA, JConfig(**KW), total_moves=MOVES,
                             segment_iters=SEG, checkpoint_path=ck,
                             resume=True)
    assert res.stream == straight
    assert int(res.moves) == MOVES


def test_resume_accounting_with_proposals(tmp_path):
    """moves_done counts chains*proposals per iteration: a resumed run
    rebuilds ITERATIONS, continues bit-identically and completes the
    whole budget."""
    kw = dict(KW, proposals=2)
    moves = 8 * 2 * 30
    want = JCM.compress_block(DATA, JConfig(**kw), total_moves=moves,
                              segment_iters=SEG).stream
    ck = str(tmp_path / "blkp.npz")
    _interrupted(TCM, TConfig(**kw), ck, 1, moves=moves, device="cpu")
    res = TCM.compress_block(DATA, TConfig(**kw), total_moves=moves,
                             segment_iters=SEG, checkpoint_path=ck,
                             resume=True, device="cpu")
    assert res.stream == want
    assert res.moves == moves


def test_checkpoint_forward_compat(tmp_path):
    """An npz written before AnnealState grew the sweep fields loads with
    their defaults (sweep_j=0: a fresh full walk) and runs; a missing
    required array raises the incompatibility error."""
    cfg = TConfig(**KW)
    ctx = TE.make_context(DATA, cfg, "cpu")
    state = TE.init_state(ctx, cfg)
    path = str(tmp_path / "new.npz")
    TCK.save(path, state)
    old = dict(np.load(path))
    legacy = {k: v for k, v in old.items()
              if k not in ("chains.snap_carry", "sweep_j", "snap_pos",
                           "u_prev", "skey")}
    oldpath = str(tmp_path / "old.npz")
    np.savez(oldpath, **legacy)
    loaded = TCK.load(oldpath, "cpu")
    assert loaded.chains.snap_carry.shape == state.chains.snap_carry.shape
    assert loaded.sweep_j == 0
    out = TE.run_iters(loaded, ctx, cfg, 2)
    assert out.moves_done > loaded.moves_done

    broken = {k: v for k, v in old.items() if k != "chains.slab"}
    badpath = str(tmp_path / "bad.npz")
    np.savez(badpath, **broken)
    with pytest.raises(ValueError, match="incompatible checkpoint"):
        TCK.load(badpath, "cpu")


def test_checkpoint_extra_metadata_and_layout(tmp_path):
    """extra.* arrays ride the same npz; the layout and dtypes are the
    reference's (uint32 slabs and keys, int32 else)."""
    from megalania_tpu.anneal import engine as JE
    from megalania_tpu.utils import checkpoint as JCK

    cfg = TConfig(**KW)
    state = TE.init_state(TE.make_context(DATA, cfg, "cpu"), cfg)
    path = str(tmp_path / "meta.npz")
    TCK.save(path, state, extra={"block_ids": np.asarray([3, 5, 9])})
    assert list(TCK.load_extra(path, "block_ids")) == [3, 5, 9]
    assert TCK.load_extra(path, "missing_key") is None
    loaded = TCK.load(path, "cpu")
    np.testing.assert_array_equal(loaded.chains.slab.numpy(),
                                  state.chains.slab.numpy())

    jstate = JE.init_state(JE.make_context(DATA, JConfig(**KW)),
                           JConfig(**KW))
    jpath = str(tmp_path / "ref.npz")
    JCK.save(jpath, jstate)
    with np.load(path) as t, np.load(jpath) as j:
        assert set(t.files) - {"extra.block_ids"} == set(j.files)
        for k in j.files:
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_metrics_and_checkpoint_through_cli(tmp_path, capsys):
    """--checkpoint/--resume/--metrics-jsonl: a resumed CLI run over a
    checkpoint directory with one finished block and one half-done block
    gives the bytes of an uninterrupted run, and the metrics end at
    iter == iters."""
    src = tmp_path / "in.bin"
    src.write_bytes(LIBC[20000:20000 + 384])
    args = ["compress", str(src), "--device", "cpu", "--chains", "8",
            "--block-size", "256", "--moves", "64", "--quiet"]
    plain, out = tmp_path / "plain.lzma", tmp_path / "out.lzma"
    assert cli.main(args + ["-o", str(plain)]) == 0
    ckdir = tmp_path / "ck"
    mj = tmp_path / "m.jsonl"
    assert cli.main(args + ["-o", str(out), "--checkpoint", str(ckdir),
                            "--metrics-jsonl", str(mj)]) == 0
    assert out.read_bytes() == plain.read_bytes()
    assert sorted(os.listdir(ckdir)) == ["block0.lzma", "block1.lzma"]
    recs = [json.loads(line) for line in open(mj)]
    assert [r["block"] for r in recs] == [0, 1]
    assert all(r["iter"] == r["iters"] for r in recs)

    # block 1 killed halfway: no stream yet, its state after 2 of its 4
    # iterations in block1.npz
    os.unlink(ckdir / "block1.lzma")
    with pytest.raises(Interrupt):
        TCM.compress_block(src.read_bytes()[256:], TConfig(
            chains=8, block_size=256), total_moves=32, segment_iters=2,
            checkpoint_path=str(ckdir / "block1.npz"), checkpoint_every=1,
            progress=_kill, device="cpu")
    assert TCK.load(str(ckdir / "block1.npz"), "cpu").moves_done == 16
    assert cli.main(args + ["-o", str(out), "--checkpoint", str(ckdir),
                            "--resume"]) == 0
    assert out.read_bytes() == plain.read_bytes()
    assert sorted(os.listdir(ckdir)) == ["block0.lzma", "block1.lzma"]
    assert cli.main(["verify", str(src), str(out)]) == 0
    assert capsys.readouterr().out.strip().endswith("OK")
