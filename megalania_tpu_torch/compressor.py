"""Top-level compression API: file bytes -> .lzma / .mlz container.

Blocks are independent LZMA-alone streams on a work queue (the block
queue of megalania_tpu.compressor), with per-block checkpoint/resume
(exact: the PRNG keys are part of the state), structured metrics, wide
(> 1 MiB) DP-only blocks, and scale-out over torch.distributed: when a
process group of more than one rank is up, the blocks are shared out
over block groups and each block's chains over the ranks of its group
(parallel/mesh.py), and the streams are gathered in order at the end.
A block that fails raises.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np

from .anneal import engine
from .anneal.config import AnnealConfig
from .match import optparse
from .models import packets as P
from .parallel import blocks as blocks_mod
from .parallel import mesh as mesh_mod
from .parallel import multihost
from .runtime import emit as emit_mod
from .utils import checkpoint as ckpt_mod
from .utils.metrics import MetricsLogger
from .utils.profiling import span


@dataclass
class BlockResult:
    stream: bytes
    raw_len: int
    predicted_bytes: float
    moves: int
    seconds: float


def reference_budget(n: int, cfg: AnnealConfig) -> int:
    """Total moves the reference would spend on an n-byte input
    (3 steps x 200 epochs x n iters, main.c:66-69)."""
    return cfg.num_steps * cfg.num_epochs * max(n, 1)


def compress_block(data: bytes, cfg: AnnealConfig,
                   total_moves: Optional[int] = None,
                   segment_iters: int = 256,
                   progress: Optional[Callable[[dict], None]] = None,
                   checkpoint_path: Optional[str] = None,
                   checkpoint_every: int = 4,
                   resume: bool = False,
                   metrics: Optional[MetricsLogger] = None,
                   block_id: int = 0, device="cuda",
                   group=None) -> BlockResult:
    """Anneal one block on `device` and emit its .lzma stream.

    checkpoint_path: npz file updated every `checkpoint_every` segments
    and at the end; with resume=True an existing file continues the run
    exactly.  group: the chain group this block's chains are split over
    (every rank of it calls this function); the checkpoint then holds the
    whole block's state, written by the group's rank 0, so it resumes
    under any layout, a single process included.  Progress and metrics
    come from the group's rank 0.
    """
    t0 = time.time()
    n = len(data)
    if n == 0:
        return BlockResult(emit_mod.emit(b"", np.zeros(0, np.uint32)), 0,
                           18.0, 0, time.time() - t0)
    if total_moves == 0:
        # DP-only mode: emit the configured initial parse directly (the
        # only mode for wide blocks)
        slab, dists = optparse.seed_slab(data, cfg, device)
        stream = emit_mod.emit(data, slab, dict_size=cfg.dict_size,
                               lc=cfg.lc, dists=dists)
        return BlockResult(stream, n, 0.0, 0, time.time() - t0)
    if n > P.MAX_BLOCK:
        raise ValueError(
            f"blocks over {P.MAX_BLOCK} bytes exceed the packed dist "
            "field and run the wide DP-only pipeline: pass "
            "total_moves=0 (CLI --moves 0)")
    if total_moves is None:
        total_moves = reference_budget(n, cfg)
    # one move = one costed proposal (the reference's unit, main.c:78);
    # an iteration costs chains * proposals of them
    iters = max(1, total_moves // (cfg.chains * cfg.proposals))
    rank, size = engine.chain_shard(group)
    lead = rank == 0

    ctx = engine.make_context(data, cfg, device)
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        state = ckpt_mod.load(checkpoint_path, device)
        # moves_done counts chains*proposals per iteration; rebuild the
        # completed ITERATIONS (the unit the loop advances by)
        done = state.moves_done // (cfg.chains * cfg.proposals)
        if group is not None:
            state = mesh_mod.shard_state(state, rank, size)
    else:
        state = engine.init_state(ctx, cfg, group)
        done = 0
    segs = 0
    seg_t, seg_moves = time.time(), state.moves_done
    while done < iters:
        seg = min(segment_iters, iters - done)
        state = engine.run_iters(state, ctx, cfg, seg, group)
        done += seg
        segs += 1
        if checkpoint_path and (segs % checkpoint_every == 0
                                or done >= iters):
            whole = (state if group is None
                     else mesh_mod.gather_state(state, group))
            if lead:
                ckpt_mod.save(checkpoint_path, whole)
        with span("block.wait"):
            best = engine.best_cost_bytes(state)  # waits for the device
        now = time.time()
        info = {
            "block": block_id,
            "iter": done,
            "iters": iters,
            "moves": state.moves_done,
            "moves_per_sec": round((state.moves_done - seg_moves)
                                   / max(now - seg_t, 1e-9), 1),
            "best_bytes": round(best, 2),
            "epochs": state.epochs_done,
        }
        if group is not None:
            info["chain_ranks"] = size
        seg_t, seg_moves = now, state.moves_done
        if lead and metrics is not None:
            metrics.log(**info)
        if lead and progress is not None:
            progress(info)
    with span("block.wait"):
        best_slab = P.to_u32(state.best_slab)
    stream = emit_mod.emit(data, best_slab, dict_size=cfg.dict_size,
                           lc=cfg.lc)
    return BlockResult(stream, n, engine.best_cost_bytes(state),
                       state.moves_done, time.time() - t0)


def compress(data: bytes, cfg: AnnealConfig = AnnealConfig(),
             total_moves: Optional[int] = None,
             progress: Optional[Callable[[dict], None]] = None,
             checkpoint_dir: Optional[str] = None,
             checkpoint_every: int = 4,
             resume: bool = False,
             metrics: Optional[MetricsLogger] = None,
             device="cuda") -> bytes:
    """Compress to a plain .lzma (single block) or .mlz container,
    annealing on `device` ("cuda" runs the kernels, "cpu" their plain
    versions).

    checkpoint_dir holds block{bi}.npz (a block's state while it runs)
    and block{bi}.lzma (its finished stream); with resume=True finished
    blocks are read back and running ones continue from their state.
    Under a process group of more than one rank every rank calls this
    with the same arguments and gets the same bytes.
    """
    parts = blocks_mod.split_blocks(data, cfg.block_size)
    world = multihost.world()[1]
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
    mesh = group = None
    if world > 1 and total_moves != 0:
        # the full-size blocks set the layout (as the reference's mesh
        # path does); the tail block joins the round-robin
        full = sum(len(p) == cfg.block_size for p in parts)
        mesh = mesh_mod.make_mesh(max(full, 1))
        group = mesh.chain_group if mesh.chains > 1 else None
    # DP-only blocks are never split: round-robin over ranks
    mine = multihost.my_blocks(len(parts), mesh)
    lead = mesh is None or mesh.chain_rank == 0

    results = {}
    for bi in mine:
        part = parts[bi]
        done_path = (os.path.join(checkpoint_dir, f"block{bi}.lzma")
                     if checkpoint_dir else None)
        if resume and done_path and os.path.exists(done_path):
            with open(done_path, "rb") as f:
                results[bi] = f.read()
            continue
        ck_path = (os.path.join(checkpoint_dir, f"block{bi}.npz")
                   if checkpoint_dir else None)
        moves = None
        if total_moves is not None:
            moves = (0 if total_moves == 0
                     else max(1, total_moves // len(parts)))
        res = compress_block(part, cfg, moves, progress=progress,
                             checkpoint_path=ck_path,
                             checkpoint_every=checkpoint_every,
                             resume=resume, metrics=metrics, block_id=bi,
                             device=device, group=group)
        results[bi] = res.stream
        if done_path and lead:
            with open(done_path, "wb") as f:
                f.write(res.stream)
            if os.path.exists(ck_path):
                os.unlink(ck_path)

    streams = multihost.gather_streams(results, len(parts))
    if len(streams) == 1:
        return streams[0]
    return blocks_mod.pack_container(streams, [len(p) for p in parts])


def decompress(blob: bytes) -> bytes:
    return blocks_mod.decompress(blob)
