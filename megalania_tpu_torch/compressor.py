"""Top-level compression API: file bytes -> .lzma / .mlz container.

Blocks are independent LZMA-alone streams, annealed one after another on
one device (the block queue of megalania_tpu.compressor); a block that
fails raises.  Mesh sharding, multi-host, checkpoint/resume, metrics and
wide (> 1 MiB) blocks are not carried by the port yet.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from .anneal import engine
from .anneal.config import AnnealConfig
from .models import packets as P
from .parallel import blocks as blocks_mod
from .runtime import emit as emit_mod


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


def _seed_slab(data: bytes, cfg: AnnealConfig) -> np.ndarray:
    """Host-only initial parse for the DP-only (total_moves=0) mode — the
    same seed functions make_context uses."""
    from .match import candidates as C_
    from .match import optparse
    from .match.suffix import build_lce

    arr = np.frombuffer(bytes(data), np.uint8)
    if cfg.init == "literal":
        return P.literal_slab(len(arr))
    if cfg.init in ("optimal", "mixed_opt"):
        return optparse.seed_slab(arr, cfg)[0]
    idx = build_lce(arr)
    tab = C_.build_candidates(arr, cfg.max_candidates, cfg.max_walk, idx)
    return C_.greedy_slab(arr, tab)


def compress_block(data: bytes, cfg: AnnealConfig,
                   total_moves: Optional[int] = None,
                   segment_iters: int = 256,
                   progress: Optional[Callable[[dict], None]] = None,
                   block_id: int = 0, device="cuda") -> BlockResult:
    """Anneal one block on `device` and emit its .lzma stream."""
    t0 = time.time()
    n = len(data)
    if n > P.MAX_BLOCK:
        raise NotImplementedError(
            f"block of {n} bytes: wide (> {P.MAX_BLOCK} byte) blocks are "
            "not carried by megalania_tpu_torch yet")
    if n == 0:
        return BlockResult(emit_mod.emit(b"", np.zeros(0, np.uint32)), 0,
                           18.0, 0, time.time() - t0)
    if total_moves == 0:
        # DP-only mode: emit the configured initial parse directly
        stream = emit_mod.emit(data, _seed_slab(data, cfg),
                               dict_size=cfg.dict_size, lc=cfg.lc)
        return BlockResult(stream, n, 0.0, 0, time.time() - t0)
    if total_moves is None:
        total_moves = reference_budget(n, cfg)
    # one move = one costed proposal (the reference's unit, main.c:78)
    iters = max(1, total_moves // (cfg.chains * cfg.proposals))

    ctx = engine.make_context(data, cfg, device)
    state = engine.init_state(ctx, cfg)
    done = 0
    seg_t, seg_moves = time.time(), 0
    while done < iters:
        seg = min(segment_iters, iters - done)
        state = engine.run_iters(state, ctx, cfg, seg)
        done += seg
        best = engine.best_cost_bytes(state)      # waits for the device
        now = time.time()
        info = {
            "block": block_id,
            "iter": done,
            "iters": iters,
            "moves": state.moves_done,
            "moves_per_sec": (state.moves_done - seg_moves)
            / max(now - seg_t, 1e-9),
            "best_bytes": best,
            "epochs": state.epochs_done,
        }
        seg_t, seg_moves = now, state.moves_done
        if progress is not None:
            progress(info)
    stream = emit_mod.emit(data, P.to_u32(state.best_slab),
                           dict_size=cfg.dict_size, lc=cfg.lc)
    return BlockResult(stream, n, engine.best_cost_bytes(state),
                       state.moves_done, time.time() - t0)


def compress(data: bytes, cfg: AnnealConfig = AnnealConfig(),
             total_moves: Optional[int] = None,
             progress: Optional[Callable[[dict], None]] = None,
             device="cuda") -> bytes:
    """Compress to a plain .lzma (single block) or .mlz container,
    annealing on `device` ("cuda" runs the kernels, "cpu" their plain
    versions)."""
    parts = blocks_mod.split_blocks(data, cfg.block_size)
    out: List[BlockResult] = []
    for bi, part in enumerate(parts):
        moves = None
        if total_moves is not None:
            moves = (0 if total_moves == 0
                     else max(1, total_moves // len(parts)))
        out.append(compress_block(part, cfg, moves, progress=progress,
                                  block_id=bi, device=device))
    if len(out) == 1:
        return out[0].stream
    return blocks_mod.pack_container([r.stream for r in out],
                                     [r.raw_len for r in out])


def decompress(blob: bytes) -> bytes:
    return blocks_mod.decompress(blob)
