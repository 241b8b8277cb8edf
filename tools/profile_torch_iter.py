#!/usr/bin/env python3
"""Where one anneal iteration of megalania_tpu_torch spends its time on a
CUDA card: the main-path configuration (a 64 KiB block of
tools/corpus/libc.so, 128 chains, CLI defaults), a few warm-up
iterations, `--iters` iterations timed on the host clock, then as many
again under torch.profiler.

    python3 tools/profile_torch_iter.py [--iters 32] [--trace out.json]

Prints the card (nvidia-smi name and power limit), the wall time per
iteration without the profiler, the device time per iteration (the sum
of the kernels' own durations in the profiled window), the device busy
share (device time over unprofiled wall time) and the top operators by
device time.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--warmup", type=int, default=8)
    ap.add_argument("--trace", default=None,
                    help="write a chrome trace of the profiled window")
    args = ap.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_iter: no CUDA device")
    sys.path.insert(0, ROOT)
    from megalania_tpu_torch.anneal import engine
    from megalania_tpu_torch.anneal.config import AnnealConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    data = open(os.path.join(ROOT, "tools", "corpus", "libc.so"),
                "rb").read()[:65536]
    cfg = AnnealConfig(chains=128)
    ctx = engine.make_context(data, cfg, "cuda")
    state = engine.run_iters(engine.init_state(ctx, cfg), ctx, cfg,
                             args.warmup)
    torch.cuda.synchronize()
    t = time.time()
    state = engine.run_iters(state, ctx, cfg, args.iters)
    torch.cuda.synchronize()
    wall_ms = (time.time() - t) * 1e3 / args.iters
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        state = engine.run_iters(state, ctx, cfg, args.iters)
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
    print(events.table(sort_by="self_device_time_total", row_limit=15,
                       max_name_column_width=60))
    if args.trace:
        prof.export_chrome_trace(args.trace)
    return 0


if __name__ == "__main__":
    sys.exit(main())
