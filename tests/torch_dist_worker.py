"""One rank of a megalania_tpu_torch process group on the CPU (gloo), for
tests/test_torch_parallel.py.

    RANK=r WORLD_SIZE=w LOCAL_RANK=r MASTER_ADDR=127.0.0.1 MASTER_PORT=p \
        python torch_dist_worker.py SCENARIO OUTDIR [ARGS...]

Joins the group through multihost.initialize (torchrun's environment),
runs SCENARIO and writes what the test compares into OUTDIR.  Scenario
"cli" instead runs `megalania_tpu_torch.cli ARGS...`, which joins and
leaves the group itself.  Imports megalania_tpu_torch only.
"""
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from megalania_tpu_torch import cli, compressor  # noqa: E402
from megalania_tpu_torch.anneal import engine  # noqa: E402
from megalania_tpu_torch.anneal.config import AnnealConfig  # noqa: E402
from megalania_tpu_torch.parallel import mesh, multihost  # noqa: E402
from megalania_tpu_torch.utils import checkpoint  # noqa: E402

LIBC = open(os.path.join(ROOT, "tools", "corpus", "libc.so"), "rb").read()


def gather(out, rank, world):
    n_blocks = 5
    mine = multihost.my_blocks(n_blocks)
    assert mine == [bi for bi in range(n_blocks) if bi % world == rank]
    local = {bi: bytes([bi + 1]) * (10 + 7 * bi) for bi in mine}
    got = multihost.gather_streams(local, n_blocks)
    assert got == [bytes([bi + 1]) * (10 + 7 * bi) for bi in range(n_blocks)]


def run(out, rank, world, cfg_json, start, n, iters, *ck):
    """run_iters over the chain group of this rank's chains of one
    block, from a fresh state or from this rank's rows of a checkpoint
    (ck)."""
    cfg = AnnealConfig(**json.loads(cfg_json))
    data = LIBC[int(start):int(start) + int(n)]
    m = mesh.make_mesh(1)
    assert (m.blocks, m.chains, m.chain_rank) == (1, world, rank)
    ctx = engine.make_context(data, cfg, "cpu")
    if ck:
        state = mesh.shard_state(checkpoint.load(ck[0], "cpu"), rank, world)
    else:
        state = engine.init_state(ctx, cfg, m.chain_group)
    state = engine.run_iters(state, ctx, cfg, int(iters), m.chain_group)
    st = engine.state_to_numpy(state)
    arrays = {f"chains.{f}": v for f, v in st.pop("chains").items()}
    arrays.update(st)
    arrays["scalar_gathers"] = mesh.exchange_best.scalar_gathers
    arrays["slab_broadcasts"] = mesh.exchange_best.slab_broadcasts
    np.savez(os.path.join(out, f"rank{rank}.npz"), **arrays)


def compress(out, rank, world, cfg_json, start, n, total_moves, *ck):
    """compressor.compress over the group (ck: checkpoint dir, resume)."""
    cfg = AnnealConfig(**json.loads(cfg_json))
    data = LIBC[int(start):int(start) + int(n)]
    kw = dict(checkpoint_dir=ck[0], resume=True) if ck else {}
    blob = compressor.compress(data, cfg, total_moves=int(total_moves),
                               device="cpu", **kw)
    with open(os.path.join(out, f"rank{rank}.lzma"), "wb") as f:
        f.write(blob)


def block_checkpoint(out, rank, world, cfg_json, start, n, total_moves):
    """compress_block with its chains over the group, checkpointing each
    segment; the progress records go to a file."""
    cfg = AnnealConfig(**json.loads(cfg_json))
    data = LIBC[int(start):int(start) + int(n)]
    group = mesh.make_mesh(1).chain_group
    recs = []
    compressor.compress_block(
        data, cfg, total_moves=int(total_moves), segment_iters=2,
        checkpoint_path=os.path.join(out, "block.npz"), checkpoint_every=1,
        progress=recs.append, device="cpu", group=group)
    with open(os.path.join(out, f"progress{rank}.json"), "w") as f:
        json.dump(recs, f)


def main():
    torch.set_num_threads(1)
    scenario, out, *args = sys.argv[1:]
    if scenario == "cli":
        rank = int(os.environ["RANK"])
        assert cli.main(args) == 0
        assert not torch.distributed.is_initialized()
    else:
        rank = multihost.initialize("cpu")
        world = torch.distributed.get_world_size()
        try:
            globals()[scenario](out, rank, world, *args)
        finally:
            torch.distributed.destroy_process_group()
    print(f"rank{rank} OK", flush=True)


if __name__ == "__main__":
    main()
