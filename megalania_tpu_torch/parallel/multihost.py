"""Process bootstrap, block ownership and the ordered ragged stream
gather (megalania_tpu/parallel/multihost.py), over torch.distributed.

Compressed blocks are ragged (their entropy-coded length depends on the
data), so the gather pads each stream to the global maximum, all-gathers
the bytes and the true lengths, and every rank reassembles the same list
in block order.  A single process takes the identity branch.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                 "MASTER_PORT")


def initialize(device="cuda") -> int:
    """Join the process group torchrun describes in the environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT) and return
    this rank; return 0 and do nothing when it is absent.  The backend
    follows `device`: nccl for cuda (binding cuda:LOCAL_RANK first),
    gloo for cpu.  A failure raises."""
    if not all(k in os.environ for k in _TORCHRUN_ENV):
        return 0
    rank = int(os.environ["RANK"])
    backend = "gloo"
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        backend = "nccl"
    dist.init_process_group(
        backend, rank=rank, world_size=int(os.environ["WORLD_SIZE"]),
        init_method="tcp://%s:%s" % (os.environ["MASTER_ADDR"],
                                     os.environ["MASTER_PORT"]))
    return rank


def world() -> tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def my_blocks(n_blocks: int, mesh: Optional[Mesh] = None) -> List[int]:
    """The blocks this rank works on: round-robin over the mesh's block
    groups (every chain rank of a group shares its blocks), or over the
    processes without a mesh (the reference's rule; the same when c = 1)."""
    if mesh is None:
        g, b = world()
    else:
        g, b = mesh.block_group, mesh.blocks
    return [bi for bi in range(n_blocks) if bi % b == g]


def _gather(t: torch.Tensor) -> torch.Tensor:
    """all_gather over the world -> [world, *t.shape], on the device the
    backend needs (the current cuda device for nccl)."""
    dev = (torch.device("cuda", torch.cuda.current_device())
           if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = t.to(dev)
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu()


def gather_streams(local: Dict[int, bytes], n_blocks: int) -> List[bytes]:
    """Ordered ragged gather: {block_id: stream} on each rank -> the full
    list, the same on every rank.  Ranks of one block group hold the same
    streams; different groups hold disjoint blocks."""
    if world()[1] == 1:
        missing = [bi for bi in range(n_blocks) if bi not in local]
        if missing:
            raise ValueError(f"missing blocks {missing}")
        return [local[bi] for bi in range(n_blocks)]
    lens = torch.zeros(n_blocks, dtype=torch.int64)
    for bi, s in local.items():
        lens[bi] = len(s)
    true_lens = _gather(lens).max(dim=0).values
    cap = int(true_lens.max()) if n_blocks else 0
    buf = np.zeros((n_blocks, cap), np.uint8)
    for bi, s in local.items():
        buf[bi, :len(s)] = np.frombuffer(s, np.uint8)
    merged = _gather(torch.from_numpy(buf)).max(dim=0).values.numpy()
    return [merged[bi, :int(true_lens[bi])].tobytes()
            for bi in range(n_blocks)]
