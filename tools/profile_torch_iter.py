#!/usr/bin/env python3
"""Where one anneal iteration of megalania_tpu_torch spends its time on a
CUDA card: by default the main-path configuration (a 64 KiB block of
tools/corpus/libc.so, 128 chains, CLI defaults); --chains, --chain-block
(default: the CLI's rule, cli.chain_block) and --lc change it, so that
the breakdown can be taken at the scale runners' 512 chains or at lc=3.
A few warm-up
iterations (discarded), then `--iters` iterations from the initial state
timed on the host clock, then the same iterations from the same state
again under torch.profiler, so that both windows do the same work.  The
default is one sweep, the first (ceil(n / tile) tiles x 4 repeats,
starting with the full walk): on the main path 32 x 4 = 128 iterations,
the work of an average iteration of its 256; at 512 chains the tile is
512 and the sweep 512 iterations, at lc=3 (128 chains) 1,024 and 256.

    python3 tools/profile_torch_iter.py [--iters SWEEP] [--chains 128]
        [--chain-block CB] [--lc 0] [--trace-dir DIR] [--root CHECKOUT]

--root profiles the megalania_tpu_torch of another checkout (default:
this one), so that one call can alternate two trees (parent, change,
change, parent); cards differ between calls.

Prints the card (nvidia-smi name and power limit), the host time to
build the block's context on the card from its numpy fields
(engine.context_from_numpy: the host-to-device copies and the log2
correction; median of 50, host clock around the call and a
synchronize), the wall time per
iteration without the profiler, the device time per iteration (the sum
of the kernels' own durations in the profiled window), the device busy
share (device time over unprofiled wall time), the repair kernel's and
the proposal kernel's device time, share and launches per iteration,
and the top operators by device time.  The
timing and the trace go through the library's own hooks
(megalania_tpu_torch/utils/profiling.py): step_timer for the unprofiled
window, trace for the profiled one, whose chrome trace is written to
DIR/trace.json.

Last, the repair kernel's full walk of the same block: its device time
(CUDA events), then where it spends its cycles, role by role: the kernel
library is rebuilt with MEG_REPAIR_PROFILE (csrc/repair.cu: each role
counts its cycles and the cycles it waits for the other, and the waits
spin so that no wait hides inside a suspended try_wait), and the walk is
timed again.  The role that waits least bounds the walk.  The same build
counts for the walker's one-packet lookahead, as shares of the chain's
records, the long reps whose repair changed the old word's length
(walker_lookahead_miss_share: a lookahead from the old word would miss
there, so the walker issues a long rep's after its re-aim) and the
packets whose successor lies past the tile (walker_lookahead_edge_share:
the lookahead stops at the edge).  That build is for these counts only:
its spinning waits and counters make it no yardstick of speed.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=0,
                    help="iterations timed and profiled (0 = one sweep)")
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--chains", type=int, default=128)
    ap.add_argument("--chain-block", type=int, default=0,
                    help="chains per block of the sweep-tile rule (0 = "
                    "the CLI's rule for --chains and --lc)")
    ap.add_argument("--lc", type=int, default=0)
    ap.add_argument("--trace-dir", default=os.path.join(
        ROOT, "megalania_tpu_torch", "_build", "profile_torch_iter"),
        help="directory for the chrome trace of the profiled window")
    ap.add_argument("--root", default=ROOT,
                    help="checkout whose megalania_tpu_torch is profiled")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_iter: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))
    from megalania_tpu_torch import cli
    from megalania_tpu_torch.anneal import engine
    from megalania_tpu_torch.anneal.config import AnnealConfig
    from megalania_tpu_torch.utils import profiling

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    data = open(os.path.join(ROOT, "tools", "corpus", "libc.so"),
                "rb").read()[:65536]
    cfg = AnnealConfig(chains=args.chains, lc=args.lc, chain_block=(
        args.chain_block or cli.chain_block(args.chains, args.lc)))
    ctx = engine.make_context(data, cfg, "cuda")
    tile = engine.choose_tile(len(data), cfg.chain_block, cfg.lc)
    args.iters = args.iters or -(-len(data) // tile) * cfg.sweep_repeats
    print(f"root: {os.path.relpath(os.path.abspath(args.root), ROOT)} "
          f"chains={cfg.chains} chain_block={cfg.chain_block} lc={cfg.lc} "
          f"tile={tile} "
          f"block_context_host_ms={context_host_ms(ctx, cfg):.6f}")
    state0 = engine.init_state(ctx, cfg)
    engine.run_iters(state0, ctx, cfg, args.warmup)
    torch.cuda.synchronize()
    with profiling.step_timer("iterations") as timed:
        state = engine.run_iters(state0, ctx, cfg, args.iters)
        timed["result"] = state
    wall_ms = timed["seconds"] * 1e3 / args.iters
    with profiling.trace(args.trace_dir) as prof:
        engine.run_iters(state0, ctx, cfg, args.iters)
        torch.cuda.synchronize()
    events = prof.key_averages()
    # kernels only: an operator's own device time repeats its kernels'
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3 \
        / args.iters
    launches = sum(e.count for e in kernels) / args.iters
    print(f"card: {smi}")
    print(f"iterations={args.iters} wall_ms_per_iter={wall_ms:.3f} "
          f"moves_per_s={cfg.chains * 1e3 / wall_ms:.1f} "
          f"device_ms_per_iter={dev_ms:.3f} "
          f"device_busy_share={dev_ms / wall_ms:.4f} "
          f"kernel_launches_per_iter={launches:.1f}")
    for name in ("repair", "propose"):
        mine = [e for e in kernels if f"{name}_kernel" in e.key]
        ms = sum(e.self_device_time_total for e in mine) / 1e3 / args.iters
        print(f"{name}_kernel_ms_per_iter={ms:.4f} "
              f"{name}_share_of_device={ms / dev_ms:.4f} "
              f"{name}_launches_per_iter="
              f"{sum(e.count for e in mine) / args.iters:.1f}")
    print(events.table(sort_by="self_device_time_total", row_limit=15,
                       max_name_column_width=60))
    print(f"trace: {os.path.join(args.trace_dir, 'trace.json')}")
    repair_roles(ctx, state.chains.slab, cfg.lc)
    return 0


def context_host_ms(ctx, cfg, reps: int = 50) -> float:
    """Host ms to build `ctx` again on its device from numpy fields, as a
    block context is built: median of `reps` calls after a warm-up."""
    import statistics
    import time
    import torch
    from megalania_tpu_torch.anneal import engine
    from megalania_tpu_torch.models import packets as P
    fields = {f: getattr(ctx, f).cpu().numpy() for f in (
        "data", "rank", "sparse", "cand_dist", "cand_len", "cand_count")}
    fields["init_slab"] = P.to_u32(ctx.init_slab)
    ms = []
    for _ in range(reps + 1):
        t = time.perf_counter()
        engine.context_from_numpy(**fields, lc=cfg.lc, device=ctx.device)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return statistics.median(ms[1:])


def repair_roles(ctx, slab, lc: int, reps: int = 5):
    """The repair kernel's full walk of `slab`: its device time, then,
    from a profiling build, per packet per chain each role's busy and
    waiting cycles (walker, coster, and the first of the two planners,
    which plans every other packet) and the walker's lookahead counts."""
    import numpy as np
    import torch
    from megalania_tpu_torch.ops import cuda_lib, repair_cuda
    from megalania_tpu_torch.runtime import build
    C, n = slab.shape
    rng = np.random.default_rng(1673551)
    q, u = (torch.as_tensor(rng.integers(0, n, C), dtype=torch.int32,
                            device=slab.device) for _ in range(2))

    def walk():
        return repair_cuda.repair_cost_cuda(
            slab, q, u, ctx.data_u8, ctx.cand_dist, ctx.cand_len, ctx.log2,
            lrep_fallback="match", lc=lc)

    def walk_ms():
        walk()
        torch.cuda.synchronize()
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        for _ in range(reps):
            walk()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / reps

    print(f"repair_full_walk_ms={walk_ms():.3f} C={C} n={n}")
    so = ctypes.CDLL(build.cuda_lib_path(("MEG_REPAIR_PROFILE",)))
    for name, argtypes in cuda_lib._SIGNATURES.items():
        getattr(so, name).argtypes = argtypes
        getattr(so, name).restype = ctypes.c_int
    so.meg_repair_profile.argtypes = [ctypes.c_void_p]
    cuda_lib.lib = lambda: so          # the wrappers launch this build
    ms = walk_ms()
    # a kernel without the lookahead counters has 7 columns
    cols = (so.meg_repair_profile_columns()
            if hasattr(so, "meg_repair_profile_columns") else 7)
    prof = np.zeros((1024, cols), np.uint64)
    if so.meg_repair_profile(prof.ctypes.data) != 0:
        raise RuntimeError("reading the repair profile counters failed")
    w_tot, w_wait, c_tot, c_wait, recs, p_tot, p_wait = \
        prof[:C, :7].astype(np.float64).T
    print(f"repair_full_walk_profiling_build_ms={ms:.3f} C={C} n={n} "
          f"records_per_chain={recs.mean():.1f} "
          f"clock_ghz~{w_tot.mean() / ms / 1e6:.3f}")
    print("walker_busy_cycles_per_packet="
          f"{((w_tot - w_wait) / recs).mean():.1f} "
          f"walker_wait_cycles_per_packet={(w_wait / recs).mean():.1f} "
          "coster_busy_cycles_per_packet="
          f"{((c_tot - c_wait) / recs).mean():.1f} "
          f"coster_wait_cycles_per_packet={(c_wait / recs).mean():.1f} "
          "planner_busy_cycles_per_packet="
          f"{((p_tot - p_wait) / recs).mean():.1f} "
          f"planner_wait_cycles_per_packet={(p_wait / recs).mean():.1f}")
    if cols >= 9:
        misses, edges = prof[:C, 7:9].astype(np.float64).T
        print("walker_lookahead_miss_share="
              f"{(misses / recs).mean():.6f} "
              "walker_lookahead_edge_share="
              f"{(edges / recs).mean():.6f}")


if __name__ == "__main__":
    sys.exit(main())
