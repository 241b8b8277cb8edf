"""megalania_tpu_torch's scale-out over torch.distributed, on the CPU:
2-process gloo groups (tests/torch_dist_worker.py) against one process
and against megalania_tpu.  Chain sharding reproduces the single-process
AnnealState row for row, multi-block compress gives the reference's
bytes, a resume picks up finished and half-done blocks, and the best
slab crosses ranks only on iterations where the best improved."""
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from megalania_tpu import compressor as JCM
from megalania_tpu.anneal.config import AnnealConfig as JConfig
from megalania_tpu_torch import cli, compressor as TCM
from megalania_tpu_torch.anneal import engine as TE
from megalania_tpu_torch.anneal.config import AnnealConfig as TConfig
from megalania_tpu_torch.parallel import mesh, multihost
from megalania_tpu_torch.utils import checkpoint as TCK
from megalania_tpu_torch.utils import fixedpoint as fp

HERE = os.path.dirname(os.path.abspath(__file__))
LIBC = open(os.path.join(os.path.dirname(HERE), "tools", "corpus",
                         "libc.so"), "rb").read()
# odd chains per rank, so a local chain id and its global id differ in
# parity (the mixed acceptance and init splits key on it)
BASE = dict(chains=6, max_candidates=8, max_walk=48, top_k=12,
            iters_per_epoch=4, init="greedy")


def _spawn(tmp_path, scenario, *args, world=2):
    """Run tests/torch_dist_worker.py SCENARIO on `world` gloo ranks."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out = tmp_path / scenario
    out.mkdir(exist_ok=True)
    env = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dist_worker.py"),
         scenario, str(out), *map(str, args)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=120)[0].decode(errors="replace")
                for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0 and f"rank{r} OK" in log, log[-3000:]
    return out


def test_multihost_single_process():
    """Without a process group: initialize is a no-op, every block is
    ours, the ordered gather is the identity."""
    assert multihost.initialize() == 0
    assert multihost.my_blocks(5) == [0, 1, 2, 3, 4]
    streams = {0: b"aa", 1: b"", 2: b"ccc"}
    assert multihost.gather_streams(streams, 3) == [b"aa", b"", b"ccc"]
    m = mesh.make_mesh(4)
    assert (m.blocks, m.chains, m.chain_group) == (1, 1, None)


@pytest.mark.parametrize("n_blocks,world,want", [
    (4, 2, (2, 1)), (5, 2, (1, 2)), (3, 4, (1, 4)), (6, 4, (2, 2)),
    (8, 4, (4, 1)), (1, 1, (1, 1))])
def test_mesh_layout(n_blocks, world, want):
    """The reference's divisor rule: the most block groups dividing both
    the world and the block count."""
    import jax
    from megalania_tpu.parallel import mesh as JM
    assert mesh.layout(n_blocks, world) == want
    assert JM.make_mesh(n_blocks, jax.devices()[:world]).devices.shape \
        == want


def test_ragged_gather_two_processes(tmp_path):
    _spawn(tmp_path, "gather")


def _improvements(state, ctx, cfg, iters):
    """Iterations on which the single-process best improved."""
    count = 0
    for _ in range(iters):
        nxt = TE.run_iters(state, ctx, cfg, 1)
        count += bool(fp.less(nxt.best_hi, nxt.best_lo, state.best_hi,
                              state.best_lo))
        state = nxt
    return state, count


# restart_from_best: two iterations per epoch and one epoch per step, so
# every restart after the first reseeds all chains from the best, and the
# best improves on restart iterations (a shard that reseeded from its own
# stale best would diverge)
RESEED = dict(site_schedule="random", iters_per_epoch=2, num_epochs=6)


# accept_mixed: the cooled/greedy split by chain id bites once the cooled
# transition probability drops below 1, so run the default epoch length
@pytest.mark.parametrize("extra,start,n,iters,improves", [
    ({}, 24576, 256, 6, True),
    ({"accept": "mixed", "iters_per_epoch": None}, 24576, 512, 10, False),
    ({"init": "mixed_opt"}, 24576, 256, 6, False),
    (RESEED, 60000, 256, 12, True)],
    ids=["default", "accept_mixed", "init_mixed_opt", "restart_from_best"])
def test_chain_sharding_equals_one_process(tmp_path, extra, start, n, iters,
                                           improves):
    """2 ranks x 3 chains: rank r holds rows 3r..3r+2 of the
    single-process state and the same best.  The (hi, lo) scalars are
    gathered every iteration; the n-sized best slab is broadcast exactly
    on the iterations where the best improved, and not on the others
    (from the greedy seed the best improves on some iterations)."""
    kw = dict(BASE, **extra)
    out = _spawn(tmp_path, "run", json.dumps(kw), start, n, iters)
    cfg = TConfig(**kw)
    ctx = TE.make_context(LIBC[start:start + n], cfg, "cpu")
    ref, improved = _improvements(TE.init_state(ctx, cfg), ctx, cfg, iters)
    if cfg.iters_per_epoch:
        assert ref.epochs_done >= 1               # restarts included
    assert (0 < improved < iters) if improves else improved == 0
    want = TE.state_to_numpy(ref)
    for r in range(2):
        with np.load(out / f"rank{r}.npz") as z:
            for f, v in want["chains"].items():
                np.testing.assert_array_equal(z[f"chains.{f}"],
                                              v[3 * r:3 * r + 3], err_msg=f)
            for f, v in want.items():
                if f != "chains":
                    np.testing.assert_array_equal(z[f], v, err_msg=f)
            assert int(z["scalar_gathers"]) == iters
            assert int(z["slab_broadcasts"]) == improved


def test_snapshot_position_is_the_block_minimum(tmp_path):
    """The sweep's capture position is the minimum over every chain of
    the block, not of one rank's shard.  From a state in the second
    stratum (positions 256..511) in which one chain of rank 1 restarts
    its walk from the snapshot at position 100, one iteration on 2 ranks
    captures where one process does: at 0, not at rank 0's own 256."""
    kw = dict(BASE, iters_per_epoch=None)
    start, n = 24576, 512
    cfg = TConfig(**kw)
    ctx = TE.make_context(LIBC[start:start + n], cfg, "cpu")
    st = TE.state_to_numpy(TE.run_iters(TE.init_state(ctx, cfg), ctx, cfg,
                                        5))
    assert st["sweep_j"] == 5
    assert (st["chains"]["rec_live"][:3] >= 256).all()
    st["chains"]["rec_live"][4] = n             # fresh: walk from snapshot
    st["chains"]["snap_carry"][4, 5] = 100
    ck = str(tmp_path / "crafted.npz")
    TCK.save(ck, TE.state_from_numpy(st, "cpu"))
    ref = TE.run_iters(TCK.load(ck, "cpu"), ctx, cfg, 1)
    assert int(ref.snap_pos) == 0
    out = _spawn(tmp_path, "run", json.dumps(kw), start, n, 1, ck)
    want = TE.state_to_numpy(ref)
    for r in range(2):
        with np.load(out / f"rank{r}.npz") as z:
            assert int(z["snap_pos"]) == 0
            for f, v in want["chains"].items():
                np.testing.assert_array_equal(z[f"chains.{f}"],
                                              v[3 * r:3 * r + 3], err_msg=f)


def test_compress_two_processes_equals_reference(tmp_path):
    """4 equal blocks plus a tail on 2 ranks (2 block groups of 1 rank):
    every rank returns the reference's container."""
    kw = dict(chains=8, block_size=512, max_candidates=8, max_walk=32)
    start, n, moves = 30000, 4 * 512 + 100, 5 * 8 * 4
    out = _spawn(tmp_path, "compress", json.dumps(kw), start, n, moves)
    data = LIBC[start:start + n]
    want = JCM.compress(data, JConfig(**kw), total_moves=moves,
                        use_mesh=False)
    for r in range(2):
        assert (out / f"rank{r}.lzma").read_bytes() == want
    assert TCM.decompress(want) == data


def test_cli_distributed(tmp_path):
    """`cli --distributed compress` on 2 ranks (a full block and a tail,
    chains over both ranks): rank 0 writes the single-process bytes and
    both ranks leave the group."""
    src, one, two = (tmp_path / f for f in ("in.bin", "one.lzma",
                                            "two.lzma"))
    src.write_bytes(LIBC[45000:45000 + 600])
    args = ["compress", str(src), "--device", "cpu", "--chains", "8",
            "--block-size", "512", "--moves", "64", "--init", "greedy"]
    assert cli.main(args + ["-o", str(one), "--quiet"]) == 0
    out = _spawn(tmp_path, "cli", "--distributed", *args, "-o", str(two))
    assert two.read_bytes() == one.read_bytes()
    assert not os.listdir(out)


def test_sharded_resume_after_partial(tmp_path):
    """3 equal blocks on 2 ranks (1 block group, chains over 2 ranks),
    resumed over a checkpoint directory where block 0 is finished and
    block 1 was interrupted by a single process: the container equals
    an uninterrupted run's, and the directory ends with the finished
    streams only."""
    kw = dict(BASE, block_size=256)
    start, n, moves = 40000, 3 * 256, 3 * 6 * 8
    data = LIBC[start:start + n]
    cfg = TConfig(**kw)
    straight = TCM.compress(data, cfg, total_moves=moves, device="cpu")
    streams = TCM.blocks_mod.unpack_container(straight)
    ck = tmp_path / "ck"
    ck.mkdir()
    (ck / "block0.lzma").write_bytes(streams[0])

    class Interrupt(Exception):
        pass

    def bomb(info):
        raise Interrupt
    with pytest.raises(Interrupt):
        TCM.compress_block(data[256:512], cfg, total_moves=moves // 3,
                           segment_iters=3, checkpoint_path=str(
                               ck / "block1.npz"),
                           checkpoint_every=1, progress=bomb, device="cpu")
    assert TCK.load(str(ck / "block1.npz"), "cpu").moves_done == 3 * 6

    out = _spawn(tmp_path, "compress", json.dumps(kw), start, n, moves,
                 str(ck))
    for r in range(2):
        assert (out / f"rank{r}.lzma").read_bytes() == straight
    assert sorted(os.listdir(ck)) == ["block0.lzma", "block1.lzma",
                                      "block2.lzma"]
    assert [(ck / f"block{i}.lzma").read_bytes() for i in range(3)] \
        == streams


def test_sharded_checkpoint_resumes_in_one_process(tmp_path):
    """A block annealed over 2 ranks checkpoints its whole state (rank 0
    writes it); that state equals the single-process one, and a single
    process resumes it to the uninterrupted bytes."""
    kw = dict(BASE)
    start, n = 24576, 256
    out = _spawn(tmp_path, "block_checkpoint", json.dumps(kw), start, n,
                 4 * 6)
    cfg = TConfig(**kw)
    data = LIBC[start:start + n]
    ctx = TE.make_context(data, cfg, "cpu")
    ref = TE.state_to_numpy(TE.run_iters(TE.init_state(ctx, cfg), ctx, cfg,
                                         4))
    got = TE.state_to_numpy(TCK.load(str(out / "block.npz"), "cpu"))
    for f, v in ref["chains"].items():
        np.testing.assert_array_equal(got["chains"][f], v, err_msg=f)
    for f, v in ref.items():
        if f != "chains":
            np.testing.assert_array_equal(got[f], v, err_msg=f)
    recs = json.loads((out / "progress0.json").read_text())
    assert [(r["iter"], r["chain_ranks"]) for r in recs] == [(2, 2), (4, 2)]
    assert json.loads((out / "progress1.json").read_text()) == []

    want = TCM.compress_block(data, cfg, total_moves=8 * 6, device="cpu")
    res = TCM.compress_block(data, cfg, total_moves=8 * 6, device="cpu",
                             checkpoint_path=str(out / "block.npz"),
                             resume=True)
    assert res.stream == want.stream and res.moves == 8 * 6


def test_shard_state_rows():
    """shard_state cuts a whole state into contiguous chain rows and
    refuses a split that leaves ranks unequal."""
    cfg = TConfig(**BASE)
    ctx = TE.make_context(LIBC[24576:24576 + 128], cfg, "cpu")
    state = TE.init_state(ctx, cfg)
    parts = [mesh.shard_state(state, r, 3) for r in range(3)]
    assert [p.chains.slab.shape[0] for p in parts] == [2, 2, 2]
    for f, whole in zip(state.chains._fields, state.chains):
        assert (np.concatenate([getattr(p.chains, f).numpy()
                                for p in parts]) == whole.numpy()).all(), f
    with pytest.raises(ValueError, match="do not split"):
        mesh.shard_state(state, 0, 4)
