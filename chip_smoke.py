#!/usr/bin/env python3
"""Smoke run of megalania_tpu_torch on one CUDA card (an H100, sm_90a).

    python3 chip_smoke.py

Drives the port's paths on the card, times its kernels, and holds each
kernel against its plain version on the inputs it times (torch.equal,
tolerance 0).  The full on-card parity suite, at small shapes and at
the deployments' shapes, is tests/test_torch_cuda.py, which runs on the
card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The phases, one line each:
 1. device: torch, CUDA, the card's name and power limit;
 2. build: the kernels from this checkout, ptxas's registers per kernel;
 3. main_path: a real 64 KiB block through the CLI with 128 chains,
    verified, decoded, and no larger than its DP-only stream; its size
    against its prediction; a 2 KiB block;
 4. the kernels at the main path's shapes: each kernel against its plain
    version on the inputs it is timed on (max_abs_err), its own device
    time (the profiler's kernel durations) and its wrapper's call time,
    beside their bounds (bytes over the HBM rate, or operations over
    their peak, from this run's inputs) and the plain versions' times;
    the card's launch floor (the device time of a one-element fill) and
    the host time of one log2_correction call; the repair kernel's full
    walk per packet;
 5. device_memory: the 1 MiB deployment (lc=3, 128 chains, the DP
    seed) through the engine's entry points, every repair launch reading
    the bytes from device memory: the first walk at the host's exact
    cost (past 2**31), the kernel against its plain version on every
    chain over the block's last 8,192 positions, two iterations;
 6. cuda_vs_cpu: the engine's state after 12 iterations at 128 chains,
    scan_cost on the card against the native cost, and a small
    container, each on the card against the CPU;
 7. checkpoint: an interrupted and resumed 64 KiB block against the
    uninterrupted one;
 8. distributed: run_iters over a one-rank NCCL group against the run
    without a group;
 9. corpus_1mib: 16 blocks of 64 KiB at 512 chains in one container
    (tools/run_1mib_corpus_torch.py);
10. block_64k_lc3: a 64 KiB block at lc=3 that the anneal must improve
    (tools/run_64k_block_torch.py);
11. bench: bench_torch.py's three rows at their full settings, at the
    bests the JAX package recorded (BENCH_r05.json), and the headline's
    device and wall time an iteration;
12. bench_corpus: tools/bench_corpus_torch.py's four files at the
    reference's move budget, at the recorded bytes (BENCH_CORPUS.json).
Each drive also counts its kernels' launches, and the repair kernel's
by where it read the block's bytes (shared or device memory): the
candidate kernel's are two per block context under init=optimal and one
under greedy or mixed.  The last lines are the card's name and power
limit (nvidia-smi), a JSON object with one entry per kernel, and
{"ok": true, "device": {...}}.  Any failed check raises: the script then
exits non-zero and prints no result.  Without a CUDA device, or outside
a checkout of the repository, it fails.
"""
from __future__ import annotations

import contextlib
import io
import json
import lzma
import os
import re
import socket
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
# Peak rates of one H100 SXM (NVIDIA's data sheet): HBM3 bytes/s, float32 outside
# the tensor cores, and int32 at half that (an SM issues 64 INT32 lanes a
# clock against 128 FP32).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
I32_OPS_PER_S = 33.5e12
# integer operations per coded bit: the cost lookup, the sum, the adapt
OPS_PER_BIT = 3
# integer operations per threefry2x32 hash: 20 rounds of an add, a
# rotate and a xor, and 5 key injections of 3 adds each
OPS_PER_HASH = 20 * 3 + 5 * 3
CORPUS = os.path.join(ROOT, "tools", "corpus", "libc.so")
WORK = os.path.join(ROOT, "megalania_tpu_torch", "_build", "smoke")


def check(ok: bool, what: str):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def say(phase: str, **kw):
    print(f"[{phase}] " + "  ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over reps launches (warmed up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(fn, reps: int = 100, windows: int = 5, kernel: str = "",
              counter=None) -> float:
    """Device milliseconds per call of fn(): the median over `windows`
    torch.profiler windows of `reps` calls each, of the summed device
    durations the profiler records (kernels and copies; with `kernel`,
    only the kernels whose name holds it).  Unlike cuda_ms, the host's
    time between launches is not counted.  Every window must hold device
    time and, with `counter` (the kernel's wrapper, which counts its
    launches), one `kernel` event a launch."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        made = counter.launches if counter else 0
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and kernel in e.key]
        us = sum(e.self_device_time_total for e in rows)
        check(us > 0, f"the profiler recorded device time ({kernel})")
        if counter is not None:
            made, seen = counter.launches - made, sum(e.count for e in rows)
            check(seen == made, f"the profiler recorded every {kernel} "
                  f"launch ({seen} of {made})")
        per_call.append(us / 1e3 / reps)
    return statistics.median(per_call)


def max_abs_diff(got, want) -> int:
    """The largest |difference| over two tuples of integer outputs (0:
    equal), after checking their shapes match."""
    import torch
    worst = 0
    for g, w in zip(got, want):
        g, w = (t.detach().to("cpu", torch.int64) for t in (g, w))
        check(g.shape == w.shape, f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            worst = max(worst, int((g - w).abs().max()))
    return worst


def same_state(a: dict, b: dict, what: str):
    """Two engine.state_to_numpy dicts, field for field."""
    import numpy as np
    for f in a["chains"]:
        check(np.array_equal(a["chains"][f], b["chains"][f]),
              f"{what}: chains.{f}")
    for f in a:
        if f != "chains":
            check(np.array_equal(a[f], b[f]), f"{what}: {f}")


def bound(nbytes: float, ops: float, ops_per_s: float):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate
    and the operations over their peak rate."""
    b, o = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def repair_work(slab_in, q, out, start: int, M: int, PR: int, mut=None):
    """What one repair launch must move and do, from its inputs and its
    output: (bytes, operations, packets walked per chain).  Each input is
    read once and each output written once: the slab in and out whole
    (the prefix passes through), the block's bytes, the log2 table,
    snapshot probabilities and carries, and the candidate rows of the
    long-rep packets the repair re-aims (data-dependent: the union over
    chains of the positions where a walked packet at or after q was a
    long rep).  Operations: OPS_PER_BIT for each of the 26 bit-plan slots
    of every packet walked (an upper bound on the bits coded)."""
    import torch
    from megalania_tpu_torch.ops import repair_scan
    C, n = slab_in.shape
    src = slab_in if mut is None else repair_scan.substitute(
        slab_in, q, *mut, start)
    pos = torch.arange(n, device=slab_in.device)
    walked = (out < 0) & (pos >= start)            # live bit = sign bit
    lrep = walked & (pos >= q[:, None].long()) & (((src >> 29) & 3) == 3)
    rows = int(lrep.any(0).sum())
    packets = walked.sum(1)
    nbytes = (2 * C * n * 4 + n + 2 * rows * M * 4 + 2048 * 4
              + 2 * C * PR * 4 + 2 * C * 16 * 4 + C * 9 * 4 + 5 * C * 4 + 8)
    return nbytes, OPS_PER_BIT * 26 * int(packets.sum()), packets


def propose_work(C: int, Pn: int, NC: int, M: int, PR: int):
    """What one proposal launch must move and do: (bytes, operations).
    Read once: the chains' probabilities, keys, sites, ctx, rep stacks
    and live counts, the shared key, the two slab cells of each row, the
    Pareto row and count at each site, the LCE gathers of the four long
    reps (the site's rank, each source's rank, two sparse-table words),
    four data bytes per site, the log2 correction.  Written once: the
    next keys, the two cells, the site and the metric row of each row,
    the acceptance draw of each chain, the next shared key.  Operations:
    OPS_PER_BIT for each of the 26 slots of every candidate, and
    OPS_PER_HASH for each threefry hash (5 per chain, 30 per row, 2 more
    per row with proposals, 1 shared)."""
    rows = C * Pn
    nbytes = (C * PR * 4 + C * 16 + 16 + C * (3 + 4) * 4 + rows * 2 * 4
              + C * (2 * M + 1) * 4 + C * (1 + 4 + 8) * 4 + C * 4 * 4
              + 128 * 4
              + C * 16 + 16 + rows * 3 * 4 + C * 4 + rows * NC * 4)
    hashes = 5 * C + rows * (30 + 2 * (Pn > 1)) + 1
    return nbytes, OPS_PER_BIT * 26 * rows * NC + OPS_PER_HASH * hashes


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))

    from megalania_tpu_torch import cli, compressor
    from megalania_tpu_torch.anneal import engine
    from megalania_tpu_torch.anneal.config import AnnealConfig
    from megalania_tpu_torch.match import candidates as C_
    from megalania_tpu_torch.match import optparse, optparse_native
    from megalania_tpu_torch.match.suffix import build_lce
    from megalania_tpu_torch.models import packets as P
    from megalania_tpu_torch.ops import (candidates_cuda, log2_cuda,
                                         problayout, propose_cuda,
                                         repair_cuda, scan_cost)
    from megalania_tpu_torch.ops import tables as T
    from megalania_tpu_torch.parallel import blocks as blocks_mod
    from megalania_tpu_torch.runtime import build
    from megalania_tpu_torch.utils import fixedpoint as fp
    from repair_cases import first_proposal, repair_rows

    os.makedirs(WORK, exist_ok=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1673551)
    corpus = open(CORPUS, "rb").read()
    kernels = {
        "log2_probe": dict(source="megalania_tpu_torch/csrc/log2_probe.cu",
                           replaces="megalania_tpu/ops/pallas_repair2.py:60 "
                                    "(probe) and :67 (log2_correction)",
                           fn=log2_cuda.log2_correction_cuda),
        "repair_cost": dict(source="megalania_tpu_torch/csrc/repair.cu",
                            replaces="megalania_tpu/ops/pallas_repair2.py:206",
                            fn=repair_cuda.repair_cost_cuda),
        "propose": dict(source="megalania_tpu_torch/csrc/propose.cu",
                        replaces="megalania_tpu/ops/pallas_rank.py:57",
                        fn=propose_cuda.propose_cuda),
        "candidates": dict(source="megalania_tpu_torch/csrc/candidates.cu",
                           replaces="no TPU kernel: host numpy, "
                                    "megalania_tpu/match/candidates.py:45",
                           fn=candidates_cuda.candidates_cuda),
    }

    # ---- 1. device ---------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()
    say("device", torch=torch.__version__, cuda=torch.version.cuda,
        name=torch.cuda.get_device_name(0), smi=repr(smi),
        count=torch.cuda.device_count())

    # ---- 2. build ----------------------------------------------------
    t = time.time()
    so = build.cuda_lib_path()
    build.host_lib("optparse")
    build.host_lib("emitter")
    ptxas = open(so[:-3] + ".log").read()
    # ptxas -v, per kernel: stack, spills, registers, barriers
    entries = re.findall(r"Compiling entry function '(\w+)'.*?\n(.*?)"
                         r"Compile time", ptxas, re.S)
    names = (("repair_kernelILb1E", "repair_kernel<bytes in smem>"),
             ("repair_kernelILb0E", "repair_kernel<bytes in global>"),
             ("propose_kernel", "propose_kernel"),
             ("log2_correction", "log2_correction_kernel"),
             ("candidates_kernel", "candidates_kernel"))
    regs = {next((nm for key, nm in names if key in e), e): " ".join(
        re.sub(r"ptxas info\s*:|Function properties for \w+", "",
               txt).split()) for e, txt in entries}
    check(all(nm in regs for _, nm in names[:2]),
          f"ptxas reported both repair kernels: {regs}")
    plan64 = repair_cuda.staging_plan(65536, 0)
    say("build", seconds=round(time.time() - t, 2),
        lib=os.path.relpath(so, ROOT),
        ptxas=json.dumps(regs),
        repair_smem_bytes_64k=plan64.smem_bytes,
        repair_bytes_in_smem_64k=plan64.bytes_in_smem)

    n, C = 2048, 128
    block = corpus[16384:16384 + n]

    def ti(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)

    # ---- 3. the main path through the CLI ----------------------------
    src = os.path.join(WORK, "libc64k.bin")
    out = os.path.join(WORK, "libc64k.lzma")
    out0 = os.path.join(WORK, "libc64k.dp.lzma")
    data = corpus[:65536]
    with open(src, "wb") as f:
        f.write(data)
    total_moves = 32768
    for k in kernels.values():
        k["fn"].launches = 0
    err = io.StringIO()
    t = time.time()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["compress", src, "-o", out, "--moves",
                       str(total_moves)])
    seconds = time.time() - t
    launches = {name: k["fn"].launches for name, k in kernels.items()}
    check(rc == 0, "cli compress exit code")
    log = err.getvalue()
    progress = re.findall(r"current file size: ([0-9.]+).*?moves: (\d+)"
                          r"\s+([0-9.]+) moves/s", log)
    check(bool(progress), "compress progress lines")
    predicted, moves_done, mps = (float(progress[-1][0]),
                                  int(progress[-1][1]),
                                  float(progress[-1][2]))
    with contextlib.redirect_stdout(io.StringIO()) as vout:
        vrc = cli.main(["verify", src, out])
    check(vrc == 0 and vout.getvalue().strip() == "OK", "cli verify")
    blob = open(out, "rb").read()
    check(lzma.decompress(blob, format=lzma.FORMAT_ALONE) == data,
          "output decodes to the input")
    with contextlib.redirect_stderr(io.StringIO()):
        check(cli.main(["compress", src, "-o", out0, "--moves", "0"]) == 0,
              "cli DP-only compress")
    dp_len = len(open(out0, "rb").read())
    check(len(blob) <= dp_len, f"annealed {len(blob)} <= DP-only {dp_len}")
    # The cost model truncates every bit's cost (the reference's log2
    # table), so a 64 KiB stream runs a few bytes over its predicted size
    # even for the seed itself: hold the annealed stream to the seed's
    # own gap (within 2.5 B), and a small block to the plain 2.5 B bound.
    seed, _ = optparse.seed_slab(data, AnnealConfig(), dev)
    seed_pred = 18 + optparse_native.cost_train(
        np.frombuffer(data, np.uint8), seed)[0] / 16384.0
    gap, seed_gap = len(blob) - predicted, dp_len - seed_pred
    check(abs(gap - seed_gap) < 2.5,
          f"64 KiB: len(out) - predicted ({gap:.2f}) within 2.5 B of the "
          f"seed's truncation gap ({seed_gap:.2f})")
    small = os.path.join(WORK, "libc2k.bin")
    with open(small, "wb") as f:
        f.write(block)
    err2 = io.StringIO()
    with contextlib.redirect_stderr(err2):
        check(cli.main(["compress", small, "-o", out0, "--moves",
                        "1024"]) == 0, "cli compress 2 KiB")
    pred2 = float(re.findall(r"current file size: ([0-9.]+)",
                             err2.getvalue())[-1])
    len2 = len(open(out0, "rb").read())
    check(abs(len2 - pred2) < 2.5,
          f"2 KiB: |len(out) - predicted| < 2.5 ({len2} vs {pred2})")
    for name, cnt in launches.items():
        check(cnt > 0, f"{name} launched on the main path ({cnt})")
    check(launches["propose"] == total_moves // C,
          f"one proposal launch per iteration ({launches['propose']})")
    check(launches["candidates"] == 2 * launches["log2_probe"],
          f"two candidate tables a context under init=optimal ({launches})")
    check(moves_done == total_moves, f"moves {moves_done} == {total_moves}")
    say("main_path", bytes_in=len(data), bytes_out=len(blob),
        dp_only_bytes=dp_len, predicted=predicted,
        seed_predicted=round(seed_pred, 2), gap=round(gap, 2),
        seed_gap=round(seed_gap, 2), small_bytes=len2, small_predicted=pred2,
        moves=moves_done,
        anneal_moves_per_s=mps, seconds=round(seconds, 2),
        launches=json.dumps(launches).replace(" ", ""))

    # ---- 4. the kernels at the main path's shapes: times --------------
    cfg8 = AnnealConfig(chains=C)
    c64 = engine.make_context(data, cfg8, dev)
    s64 = engine.init_state(c64, cfg8)
    n64 = c64.data.shape[0]
    q64 = ti(rng.integers(0, n64, C))
    u64 = ti(rng.integers(0, n64, C))
    kw = dict(lrep_fallback="match")
    PR = problayout.get_layout(0).PACKED_ROWS
    M64 = c64.cand_dist.shape[1]

    def repair64(slab_in, q_, u_, **kw_):
        return repair_cuda.repair_cost_cuda(
            slab_in, q_, u_, c64.data_u8, c64.cand_dist, c64.cand_len,
            c64.log2, **kw, **kw_)
    # the full walk from the initial state (every chain on the seed parse)
    full_ms = cuda_ms(lambda: repair64(s64.chains.slab, q64, u64), 5)
    full_out = repair64(s64.chains.slab, q64, u64)
    full_bytes, full_ops, full_pk = repair_work(
        s64.chains.slab, q64, full_out[0], 0, M64, PR)
    full_bound, full_by = bound(full_bytes, full_ops, I32_OPS_PER_S)
    # a partial walk at n=65536, C=128 over the block's last 8192
    # positions, from the kernel's own snapshot there, with the mutation
    # substituted in-pass as on the main path; the plain version (one
    # Python step per position) timed on the same inputs
    start64 = n64 - 8192
    mut0 = ti(P.pack_np(P.SREP, np.zeros(C, np.int64), np.ones(C, np.int64))
              .view(np.int32))
    mut1 = ti(P.pack_np(P.LREP, rng.integers(0, 4, C), np.full(C, 2))
              .view(np.int32))
    snap = repair64(s64.chains.slab, q64, u64, cap_pos=start64)
    part_args = (snap[0], ti(rng.integers(start64, n64, C)),
                 ti(rng.integers(start64, n64, C)))
    part_kw = dict(start_pos=start64, probs_in=snap[3], carry_in=snap[8],
                   mut0=mut0, mut1=mut1)
    got = repair64(*part_args, **part_kw)
    torch.cuda.synchronize()
    t = time.time()
    want = repair_cuda.repair_cost_plain(
        *part_args, c64.data, c64.cand_dist, c64.cand_len, c64.log2, **kw,
        **part_kw)
    torch.cuda.synchronize()
    kernels["repair_cost"]["plain_ms"] = (time.time() - t) * 1e3
    d = max_abs_diff(got, want)
    check(d == 0, f"repair kernel == plain version (n={n64}, partial): {d}")
    kernels["repair_cost"]["max_abs_err"] = d
    kernels["repair_cost"]["ms"] = device_ms(
        lambda: repair64(*part_args, **part_kw), 20, 3,
        kernel="repair_kernel", counter=repair_cuda.repair_cost_cuda)
    kernels["repair_cost"]["call_ms"] = cuda_ms(
        lambda: repair64(*part_args, **part_kw), 20)
    part_bytes, part_ops, part_pk = repair_work(
        part_args[0], part_args[1], got[0], start64, M64, PR,
        mut=(mut0, mut1))
    kernels["repair_cost"]["bound_ms"], kernels["repair_cost"][
        "bound_by"] = bound(part_bytes, part_ops, I32_OPS_PER_S)
    say("repair_times", tolerance=0, max_abs_err=d, full_walk_ms=full_ms,
        full_walk_shape=f"C={C},n={n64},positions=0..{n64}",
        packets_per_chain_mean=float(full_pk.float().mean()),
        packets_per_chain_max=int(full_pk.max()),
        ns_per_packet_per_chain=full_ms * 1e6 / int(full_pk.max()),
        full_walk_bytes=full_bytes, full_walk_ops=full_ops,
        full_walk_bound_ms=full_bound, full_walk_bound_by=full_by,
        partial_ms=kernels["repair_cost"]["ms"],
        partial_shape=f"C={C},n={n64},positions={start64}..{n64}",
        partial_packets_per_chain_max=int(part_pk.max()),
        partial_bytes=part_bytes,
        partial_bound_ms=kernels["repair_cost"]["bound_ms"],
        partial_plain_ms=kernels["repair_cost"]["plain_ms"])

    # the proposal stage of the main path's first iteration
    pargs, pkw = first_proposal(c64, s64, cfg8)
    got = propose_cuda.propose_cuda(*pargs, **pkw)
    d = max_abs_diff(got, propose_cuda.propose_plain(*pargs, **pkw))
    check(d == 0, f"proposal kernel == plain version (n={n64}, C={C}): {d}")
    kernels["propose"]["max_abs_err"] = d
    kernels["propose"]["ms"] = device_ms(
        lambda: propose_cuda.propose_cuda(*pargs, **pkw),
        kernel="propose_kernel", counter=propose_cuda.propose_cuda)
    kernels["propose"]["call_ms"] = cuda_ms(
        lambda: propose_cuda.propose_cuda(*pargs, **pkw), 50)
    kernels["propose"]["plain_ms"] = cuda_ms(
        lambda: propose_cuda.propose_plain(*pargs, **pkw), 5)
    NC = got[6].shape[1]
    # the correction kernel on the main path's table (one launch per
    # block context), beside the card's launch floor: the device time of
    # a one-element fill
    table64 = c64.log2
    corr64, raw64, _ = log2_cuda.log2_correction_cuda(table64)
    words_err = max_abs_diff([corr64], [log2_cuda.correction_plain(
        raw64, table64)])
    exact64 = log2_cuda.apply_correction(raw64.cpu().numpy(),
                                         corr64.cpu().numpy())
    d = max(words_err, int(np.abs(exact64[1:].astype(np.int64)
                                  - T.LOG2_TABLE_NP[1:]).max()))
    check(d == 0, f"correction kernel == plain version, and raw + "
          f"correction == LOG2_TABLE for p in 1..2047: {d}")
    kernels["log2_probe"]["max_abs_err"] = d
    kernels["log2_probe"]["ms"] = device_ms(
        lambda: log2_cuda.log2_correction_cuda(table64),
        kernel="log2_correction", counter=log2_cuda.log2_correction_cuda)
    kernels["log2_probe"]["call_ms"] = cuda_ms(
        lambda: log2_cuda.log2_correction_cuda(table64), 50)
    kernels["log2_probe"]["plain_ms"] = device_ms(
        lambda: log2_cuda.correction_plain(raw64, table64))
    launch_floor_ms = device_ms(lambda: torch.zeros(1, device=dev))
    host = []
    for _ in range(50):
        t = time.perf_counter()
        log2_cuda.log2_correction(table64)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
    log2_host_ms = statistics.median(host)
    kernels["log2_probe"].update(launch_floor_ms=launch_floor_ms,
                                 host_ms=log2_host_ms)
    # the proposal stage: propose_work; the correction: the table read,
    # the words and the status written (raw is a verification output the
    # kernel writes on top of that), and per p a multiply, a log2, a
    # multiply and a truncation in float32
    kernels["propose"]["bound_ms"], kernels["propose"]["bound_by"] = bound(
        *propose_work(C, 1, NC, M64, PR), I32_OPS_PER_S)
    kernels["log2_probe"]["bound_ms"], kernels["log2_probe"][
        "bound_by"] = bound(2048 * 4 + (128 + 2) * 4, 4 * 2048,
                            F32_OPS_PER_S)
    # the candidate-table kernel at the main path's block, for both of a
    # context's tables (the annealer's and the optimum-parse seed's), on
    # the index and bigram chains make_context uploads: torch.equal to
    # the numpy builder (plain_ms: its host time); the bound reads the
    # chains and the index once and writes the table once.  The kernels
    # row gives one context's two tables together
    arr64 = np.frombuffer(data, np.uint8)
    idx64 = build_lce(arr64)
    cargs = [torch.as_tensor(a, device=dev) for a in (
        C_.bigram_prev(arr64).astype(np.int32), idx64.rank, idx64.sparse)]
    tables8 = {}
    for M8, walk8 in ((cfg8.max_candidates, cfg8.max_walk),
                      (cfg8.opt_candidates, cfg8.opt_walk)):
        def cand(M8=M8, walk8=walk8):
            return candidates_cuda.candidates_cuda(*cargs, M8, walk8)
        got = cand()
        torch.cuda.synchronize()
        t = time.perf_counter()
        want = C_.build_candidates(arr64, M8, walk8, idx64)
        plain8 = (time.perf_counter() - t) * 1e3
        check(all(torch.equal(g.cpu(), torch.from_numpy(w))
                  for g, w in zip(got, want)),
              f"candidate kernel == numpy table (torch.equal) at "
              f"{M8} x {walk8}, n={n64}")
        nbytes = 4 * (sum(a.numel() for a in cargs) + (2 * M8 + 1) * n64)
        tables8[f"{M8}x{walk8}"] = dict(
            ms=device_ms(cand, 20, 5, kernel="candidates_kernel",
                         counter=candidates_cuda.candidates_cuda),
            call_ms=cuda_ms(cand, 20), plain_ms=plain8,
            bound_ms=bound(nbytes, 0, I32_OPS_PER_S)[0], bytes=nbytes,
            entries_per_row=float(want.count.mean()),
            max_count=int(want.count.max()))
    kc = kernels["candidates"]
    kc["max_abs_err"] = 0
    for f in ("ms", "call_ms", "plain_ms", "bound_ms"):
        kc[f] = sum(t8[f] for t8 in tables8.values())
    kc["bound_by"] = "bytes"
    kc["tables"] = tables8
    say("candidates", n=n64, tolerance=0, equal=True,
        **{f"t{k}_{f}": v for k, t8 in tables8.items()
           for f, v in t8.items()})
    # no single PyTorch call computes any of the four functions
    for k in kernels.values():
        k["library_ms"] = None
    say("times", tolerance=0,
        repair_device_ms=kernels["repair_cost"]["ms"],
        repair_call_ms=kernels["repair_cost"]["call_ms"],
        repair_bound_ms=kernels["repair_cost"]["bound_ms"],
        repair_plain_ms=kernels["repair_cost"]["plain_ms"],
        repair_shape=f"C={C},n={n64},positions={start64}..{n64}",
        propose_device_ms=kernels["propose"]["ms"],
        propose_call_ms=kernels["propose"]["call_ms"],
        propose_bound_ms=kernels["propose"]["bound_ms"],
        propose_bound_by=kernels["propose"]["bound_by"],
        propose_plain_ms=kernels["propose"]["plain_ms"],
        propose_shape=f"C={C},NC={NC},n={n64}",
        log2_device_ms=kernels["log2_probe"]["ms"],
        log2_call_ms=kernels["log2_probe"]["call_ms"],
        log2_bound_ms=kernels["log2_probe"]["bound_ms"],
        log2_plain_device_ms=kernels["log2_probe"]["plain_ms"],
        launch_floor_ms=launch_floor_ms,
        log2_correction_host_ms=log2_host_ms)

    staged = repair_cuda.repair_cost_cuda.staged
    staged0 = {}

    def reset():
        for k in kernels.values():
            k["fn"].launches = 0
        staged0.update(staged)

    by_path = {"main_path": launches}
    staged_by_path = {}

    def launched(path: str, tables: int | None = 2) -> dict:
        """The launches since reset(), and the repair launches by where
        they read the block's bytes (staged_by_path); `tables`: candidate
        tables a context (one log2 correction each), 2 under
        init=optimal, 1 under greedy or mixed, None where the inits are
        mixed."""
        staged_by_path[path] = {k: staged[k] - staged0[k] for k in staged}
        check(sum(staged_by_path[path].values())
              == kernels["repair_cost"]["fn"].launches,
              f"every repair launch on the {path} path staged: "
              f"{staged_by_path[path]}")
        counts = {name: k["fn"].launches for name, k in kernels.items()}
        for name, cnt in counts.items():
            check(cnt > 0, f"{name} launched on the {path} path ({cnt})")
        if tables is not None:
            check(counts["candidates"] == tables * counts["log2_probe"],
                  f"{tables} candidate table(s) a context on the {path} "
                  f"path: {counts}")
        by_path[path] = counts
        return counts

    # ---- 5. the 1 MiB deployment: the bytes in device memory ----------
    # compress --block-size 1048576 --lc 3 through the engine's entry
    # points: 128 chains from the DP seed, every repair launch reading the
    # bytes from device memory; the first full walk costs every chain at
    # the host's exact cost (past 2**31), the kernel equals its plain
    # version on every chain over the block's last 8,192 positions
    # (tests/repair_cases.repair_rows), and two iterations end at a best
    # the host costs the same
    n1m = P.MAX_BLOCK
    cfg1m = AnnealConfig(chains=C, chain_block=cli.chain_block(C, 3), lc=3,
                         block_size=n1m)
    check(not repair_cuda.staging_plan(n1m, 3).bytes_in_smem,
          "a 1 MiB block reads its bytes from device memory")
    arr1m = np.frombuffer(corpus[:n1m], np.uint8)
    reset()
    t = time.time()
    c1m = engine.make_context(arr1m, cfg1m, dev)
    ctx1m_s = time.time() - t
    t = time.time()
    s1m = engine.init_state(c1m, cfg1m)
    torch.cuda.synchronize()
    init1m_s = time.time() - t
    host1m = optparse_native.cost_train(arr1m, P.to_u32(c1m.init_slab),
                                        lc=3)[0]
    card1m = {fp.to_int(h, lo) for h, lo in zip(
        s1m.chains.cost_hi.tolist(), s1m.chains.cost_lo.tolist())}
    check(card1m == {host1m} and host1m > 1 << 31,
          f"1 MiB first walk: card {sorted(card1m)[:3]} == host {host1m}")
    d = max_abs_diff(*repair_rows(c1m, cfg1m, s1m, range(C), 8192, rng))
    check(d == 0, f"repair kernel == plain version at n={n1m}, lc=3: {d}")
    kernels["repair_cost"]["max_abs_err"] = max(
        kernels["repair_cost"]["max_abs_err"], d)
    s1m = engine.run_iters(s1m, c1m, cfg1m, 2)
    best1m = optparse_native.cost_train(arr1m, P.to_u32(s1m.best_slab),
                                        lc=3)[0]
    check(fp.to_int(s1m.best_hi, s1m.best_lo) == best1m,
          f"1 MiB best after 2 iterations at the host's cost {best1m}")
    counts1m = launched("device_memory")
    check(counts1m["repair_cost"] == 1 + 2 + 2 and counts1m["propose"] == 2
          and staged_by_path["device_memory"] == {"shared": 0, "device": 5},
          f"1 MiB: the first walk, 2 checked, 2 iterations, all in device "
          f"memory: {counts1m}, {staged_by_path['device_memory']}")
    say("device_memory", n=n1m, C=C, lc=3, tolerance=0, max_abs_err=d,
        positions=f"{n1m - 8192}..{n1m}", seed_cost=host1m, iters=2,
        best_cost=best1m, context_seconds=round(ctx1m_s, 1),
        init_state_seconds=round(init1m_s, 2),
        staged=json.dumps(staged_by_path["device_memory"]).replace(" ", ""),
        launches=json.dumps(counts1m).replace(" ", ""))

    # ---- 6. the card against the CPU ---------------------------------
    # the engine's state after 12 iterations of a 2 KiB block at 128
    # chains; the whole-parse cost (scan_cost) of its best and of four
    # chains on the card against the native cost; four 2 KiB blocks and a
    # tail through compressor.compress (8 chains, 3 iterations a block)
    t = time.time()
    cfg6 = AnnealConfig(chains=C, iters_per_epoch=4)
    states6 = {}
    for d6 in (dev, "cpu"):
        c6 = engine.make_context(block, cfg6, d6)
        states6[str(d6)] = engine.run_iters(engine.init_state(c6, cfg6), c6,
                                            cfg6, 12)
    s6 = states6[str(dev)]
    same_state(engine.state_to_numpy(s6),
               engine.state_to_numpy(states6["cpu"]),
               "engine state cuda == cpu")
    parses6 = torch.cat([s6.best_slab[None], s6.chains.slab[:4]])
    hi6, lo6, _, live6 = scan_cost.parse_cost_exact(
        parses6, torch.as_tensor(np.frombuffer(block, np.uint8).astype(
            np.int32), device=dev))
    check(live6.is_cuda and bool(live6.any()), "scan_cost ran on the card")
    costs6 = [fp.to_int(h, lo) for h, lo in zip(hi6.tolist(), lo6.tolist())]
    want6 = [optparse_native.cost_train(np.frombuffer(block, np.uint8),
                                        P.to_u32(s))[0] for s in parses6]
    check(costs6 == want6, f"scan_cost {costs6} == cost_train {want6}")
    data6 = corpus[32768:32768 + 4 * 2048 + 700]
    cfg6c, moves6 = AnnealConfig(chains=8, block_size=2048), 5 * 3 * 8
    got6c, want6c = (compressor.compress(data6, cfg6c, total_moves=moves6,
                                         device=d6) for d6 in (dev, "cpu"))
    check(got6c == want6c and compressor.decompress(got6c) == data6
          and len(blocks_mod.unpack_container(got6c)) == 5,
          "container bytes cuda == cpu, 5 streams, decodes")
    say("cuda_vs_cpu", n=n, C=C, iters=12, identical=True,
        scan_cost_parses=len(costs6), container_blocks=5,
        container_bytes=len(got6c), seconds=round(time.time() - t, 1))

    # ---- 7. checkpoint/resume at 64 KiB, C=128 ------------------------
    from megalania_tpu_torch.utils import checkpoint as ckpt_mod
    from megalania_tpu_torch.utils.metrics import MetricsLogger
    cfg9 = AnnealConfig(chains=C)
    moves9, seg9 = 4 * 16 * C, 16
    ck9 = os.path.join(WORK, "libc64k.npz")
    mj9 = os.path.join(WORK, "libc64k.jsonl")
    for p in (ck9, mj9):
        if os.path.exists(p):
            os.unlink(p)
    reset()
    t = time.time()
    straight = compressor.compress_block(
        data, cfg9, total_moves=moves9, segment_iters=seg9, device=dev,
        metrics=MetricsLogger(jsonl_path=mj9))

    class Interrupt(Exception):
        pass

    def bomb(info):
        if info["iter"] == 2 * seg9:
            raise Interrupt
    try:
        compressor.compress_block(
            data, cfg9, total_moves=moves9, segment_iters=seg9, device=dev,
            checkpoint_path=ck9, checkpoint_every=1, progress=bomb)
        check(False, "the interrupted run stopped after segment 2")
    except Interrupt:
        pass
    half = ckpt_mod.load(ck9, "cpu").moves_done
    resumed = compressor.compress_block(
        data, cfg9, total_moves=moves9, segment_iters=seg9, device=dev,
        checkpoint_path=ck9, resume=True)
    counts9 = launched("checkpoint")
    recs = [json.loads(line) for line in open(mj9)]
    check(resumed.stream == straight.stream,
          "resumed bytes == uninterrupted bytes")
    check(half == 2 * seg9 * C and resumed.moves == moves9,
          f"checkpoint after segment 2 ({half} moves), resumed run "
          f"completes the budget ({resumed.moves})")
    check([r["iter"] for r in recs] == [16, 32, 48, 64]
          and recs[-1]["iter"] == recs[-1]["iters"],
          "metrics JSONL: one record per segment, ending at iter == iters")
    check(lzma.decompress(resumed.stream, format=lzma.FORMAT_ALONE) == data,
          "resumed stream decodes")
    say("checkpoint", n=len(data), C=C, segments=4, iters_per_segment=seg9,
        interrupted_after=2, resumed_equal=True,
        bytes_out=len(resumed.stream), metrics_records=len(recs),
        seconds=round(time.time() - t, 1),
        launches=json.dumps(counts9).replace(" ", ""))

    # ---- 8. chain sharding over a one-rank NCCL group -----------------
    import torch.distributed as dist
    from megalania_tpu_torch.parallel import mesh as mesh_mod, multihost
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        check(dist.get_backend() == "nccl", "the process group is NCCL")
        t = time.time()
        # from the greedy seed the best improves on some of the first
        # iterations, so the slab broadcast runs as well as the skip
        cfg11 = AnnealConfig(chains=C, iters_per_epoch=4, init="greedy")
        m = mesh_mod.make_mesh(1)
        check((m.blocks, m.chains) == (1, 1) and m.chain_group is not None,
              "one-rank mesh with a chain group")
        reset()
        mesh_mod.exchange_best.scalar_gathers = 0
        mesh_mod.exchange_best.slab_broadcasts = 0
        c11 = engine.make_context(block, cfg11, dev)
        s11 = engine.init_state(c11, cfg11, m.chain_group)
        s11 = engine.run_iters(s11, c11, cfg11, 8, m.chain_group)
        counts11 = launched("distributed", 1)
        ref11 = engine.run_iters(engine.init_state(c11, cfg11), c11, cfg11,
                                 8)
        same_state(engine.state_to_numpy(s11), engine.state_to_numpy(ref11),
                   "run_iters over NCCL == run_iters alone")
        check(mesh_mod.exchange_best.scalar_gathers == 8
              and 0 < mesh_mod.exchange_best.slab_broadcasts < 8,
              "one best exchange per iteration, the slab on some")
        streams = {bi: bytes([bi]) * (5 + bi) for bi in range(3)}
        check(multihost.gather_streams(streams, 3)
              == [streams[bi] for bi in range(3)], "gather_streams order")
        say("distributed", backend="nccl", world=1, n=n, C=C, iters=8,
            identical=True,
            slab_broadcasts=mesh_mod.exchange_best.slab_broadcasts,
            seconds=round(time.time() - t, 1),
            launches=json.dumps(counts11).replace(" ", ""))
    finally:
        dist.destroy_process_group()

    # ---- 9. the 1 MiB corpus: 16 blocks of 64 KiB at 512 chains --------
    # the scale runner tools/run_1mib_corpus_torch.py through
    # compressor.compress: one context, one log2 correction and 64
    # iterations per block (the main path's 32,768 moves), one container
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import run_1mib_corpus_torch as r1m
    import run_64k_block_torch as r64k
    blocks12, iters12, C12 = 16, 64, 512
    out12 = os.path.join(WORK, "corpus1mib.mlz")
    reset()
    with contextlib.redirect_stdout(io.StringIO()):
        res12 = r1m.main([str(iters12 * C12), str(C12), "-o", out12],
                         corpus_bytes=blocks12 << 16)
    counts12 = launched("corpus_1mib")
    data12 = r1m.corpus(blocks12 << 16)
    blob12 = open(out12, "rb").read()
    streams12 = blocks_mod.unpack_container(blob12)
    check(res12["decode_ok"] and compressor.decompress(blob12) == data12,
          "the 1 MiB container decodes")
    check(len(streams12) == blocks12, f"{len(streams12)} streams")
    for bi, st in enumerate(streams12):
        check(lzma.decompress(st, format=lzma.FORMAT_ALONE)
              == data12[bi << 16:(bi + 1) << 16], f"stream {bi} decodes")
    check(counts12["log2_probe"] == blocks12
          and counts12["propose"] == blocks12 * iters12
          and counts12["repair_cost"] == blocks12 * (iters12 + 1)
          and counts12["candidates"] == 2 * blocks12,
          f"one context per block, {iters12} iterations each: {counts12}")
    alloc12 = [b["allocated_bytes"] for b in res12["per_block"]]
    check(max(alloc12) - min(alloc12) < 16 << 20,
          f"device memory does not grow with the block index: {alloc12}")
    cfg12 = AnnealConfig(chains=C12, chain_block=cli.chain_block(C12))
    dp12 = {}
    for bi in (0, blocks12 - 1):
        dp12[bi] = len(compressor.compress_block(
            data12[bi << 16:(bi + 1) << 16], cfg12, total_moves=0).stream)
        check(len(streams12[bi]) <= dp12[bi],
              f"block {bi}: annealed {len(streams12[bi])} <= DP-only "
              f"{dp12[bi]}")
    split = res12["per_block"]
    say("corpus_1mib", n=res12["n"], blocks=blocks12, block_size=65536,
        C=C12, chain_block=res12["chain_block"], iters_per_block=iters12,
        corpus_sha256=res12["corpus_sha256"][:12],
        seconds=res12["seconds"], anneal_seconds=res12["anneal_seconds"],
        other_seconds=res12["other_seconds"],
        anneal_moves_per_s=res12["anneal_moves_per_s"],
        block_wall_s_mean=round(statistics.mean(
            b["wall_s"] for b in split), 3),
        block_anneal_s_mean=round(statistics.mean(
            b["anneal_s"] for b in split), 3),
        bytes=res12["bytes"], liblzma_9e_bytes=res12["liblzma_9e_bytes"],
        gzip9_bytes=res12["gzip9_bytes"],
        dp_only_bytes=json.dumps({f"block{bi}": v for bi, v in dp12.items()}
                                 ).replace(" ", ""),
        annealed_bytes=json.dumps({f"block{bi}": len(streams12[bi])
                                   for bi in dp12}).replace(" ", ""),
        peak_device_bytes=res12["peak_device_bytes"],
        allocated_bytes_per_block=f"{min(alloc12)}..{max(alloc12)}",
        launches=json.dumps(counts12).replace(" ", ""))

    # ---- 10. a 64 KiB block at lc=3 through the 64 KiB runner ----------
    # 128 chains (chain_block 128), init=mixed, 256 iterations: the
    # anneal must improve on its initial parses on the card.  Greedy
    # acceptance: the cooled rule's p_trans exceeds 1 for the first
    # iterations, so the chains accept every move and wander above the
    # greedy start, and in 256 iterations the best never fell below it
    for k in ("RUN64K_N", "RUN64K_CKPT"):
        os.environ.pop(k, None)
    C13, iters13 = 128, 256
    out13 = os.path.join(WORK, "block64k_lc3.lzma")
    reset()
    with contextlib.redirect_stdout(io.StringIO()):
        res13 = r64k.main([str(iters13 * C13), str(C13), "3", "mixed",
                           "greedy", "-o", out13])
    counts13 = launched("block_64k_lc3", 1)
    data13 = r64k.corpus(65536)
    blob13 = open(out13, "rb").read()
    check(res13["decode_ok"] and lzma.decompress(
        blob13, format=lzma.FORMAT_ALONE) == data13, "lc=3 block decodes")
    check(counts13["propose"] == iters13, f"{iters13} iterations: {counts13}")
    cfg13 = AnnealConfig(chains=C13, chain_block=cli.chain_block(C13, 3),
                         lc=3, init="mixed", accept="greedy")
    c13 = engine.make_context(data13, cfg13, dev)
    s13 = engine.init_state(c13, cfg13)
    first13 = engine.best_cost_bytes(s13)
    check(res13["predicted"] < first13,
          f"the anneal improved the parse: best {res13['predicted']} < "
          f"first {first13}")
    end13 = engine.run_iters(s13, c13, cfg13, iters13)
    check(engine.best_cost_bytes(end13) == res13["predicted"],
          "run_iters from the initial state ends at the runner's best")
    gap13 = len(blob13) - res13["predicted"]
    check(0 <= gap13 < 16, f"lc=3: 0 <= len(out) - predicted < 16 ({gap13})")
    say("block_64k_lc3", n=65536, C=C13, chain_block=cfg13.chain_block,
        lc=3, init="mixed", accept="greedy", iters=iters13,
        corpus_sha256=res13["corpus_sha256"][:12],
        first_best_bytes=round(first13, 4),
        best_bytes=round(res13["predicted"], 4),
        improved_by=round(first13 - res13["predicted"], 4), bytes=len(blob13),
        gap=round(gap13, 2), liblzma_9e_bytes=res13["liblzma_9e_bytes"],
        anneal_moves_per_s=res13["segments"][-1]["moves_per_sec"],
        seconds=res13["seconds"],
        repair_smem_bytes=repair_cuda.staging_plan(65536, 3).smem_bytes,
        peak_device_bytes=res13["peak_device_bytes"],
        launches=json.dumps(counts13).replace(" ", ""))

    # ---- 11. bench: bench_torch.py's three rows at full settings --------
    # 512 chains (chain_block 512) on SURVEY.md's bytes: n=2,048 with 512
    # warm-up + 512 timed iterations from init=mixed; the design point
    # n=65,536 with one sweep (512 iterations) + one, from init=mixed and
    # from init=optimal.  The mixed rows must print the bests bench.py
    # recorded (BENCH_r05.json, "%.2f"): 1244.86 and 16717.00 B
    import bench_torch
    C15 = 512
    plan15 = (("headline", bench_torch.N, 512, "mixed", "1244.86"),
              ("design_point", bench_torch.N64K, 0, "mixed", "16717.00"),
              ("converged", bench_torch.N64K, 0, "optimal", None))
    reset()
    t15 = time.time()
    rows15 = {}
    for key, n15, it15, init15, _ in plan15:
        t = time.time()
        rows15[key] = bench_torch.measure(n15, C15, it15, init=init15)
        rows15[key]["row_seconds"] = time.time() - t
    counts15 = launched("bench", None)
    rows_seconds15 = time.time() - t15
    iters15 = sum(r["iters"] for r in rows15.values())
    check([r["iters"] for r in rows15.values()] == [512, 512, 512],
          "512 iterations a window in every row (tile 256 at n=2,048 is "
          "32 a sweep; tile 512 at n=65,536 is 512)")
    check(counts15 == {"log2_probe": 3, "repair_cost": 2 * iters15 + 3,
                       "propose": 2 * iters15, "candidates": 1 + 1 + 2},
          f"one context per row, one launch per iteration, one candidate "
          f"table under mixed and two under optimal: {counts15}")
    for key, _, _, _, want in plan15:
        if want:
            got = "%.2f" % rows15[key]["best_bytes"]
            check(got == want, f"bench {key}: best {got} B == the "
                  f"recorded {want} B")
    # where an iteration's time goes at the headline shape (n=2,048, 512
    # chains): its device time (profiler) against its wall time (host
    # clock around 64 iterations ending in a synchronize), from the state
    # after 40 iterations (past the first sweep cycle)
    cfg15 = AnnealConfig(chains=C15, chain_block=bench_torch.chain_block(C15),
                         init="mixed", accept="cooled")
    c15 = engine.make_context(bench_torch.corpus(bench_torch.N), cfg15, dev)
    held = [engine.run_iters(engine.init_state(c15, cfg15), c15, cfg15, 40)]

    def step15():
        held[0] = engine.run_iters(held[0], c15, cfg15, 1)
    dev15 = device_ms(step15, 32, 3)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(64):
        step15()
    torch.cuda.synchronize()
    wall15 = (time.perf_counter() - t) * 1e3 / 64
    seconds15 = time.time() - t15
    say("bench", C=C15, chain_block=cfg15.chain_block,
        **{f"{key}_{f}": rows15[key][f] for key in rows15
           for f in ("best_bytes", "best_cost", "moves_per_s", "seconds",
                     "row_seconds")},
        headline_best="%.2f" % rows15["headline"]["best_bytes"],
        design_point_best="%.2f" % rows15["design_point"]["best_bytes"],
        headline_device_ms_per_iter=dev15, headline_wall_ms_per_iter=wall15,
        headline_busy_share=dev15 / wall15,
        rows_seconds=round(rows_seconds15, 1), seconds=round(seconds15, 1),
        launches=json.dumps(counts15).replace(" ", ""))

    # ---- 12. bench_corpus: the four corpus files at the reference budget
    # tools/bench_corpus_torch.py at n=2,048, 128 chains, 1,228,800 moves
    # (3 x 200 x n), with BENCH_CORPUS.json's overrides: the streams must
    # be the lengths megalania_tpu recorded there and decode, and
    # liblzma's preset 9 | extreme must give the recorded xz -9e column
    import bench_corpus_torch
    want16 = {"survey.md": (1224, 1257), "pallas.md": (965, 1004),
              "engine.py": (1029, 1061), "libc.so": (789, 824)}
    with open(os.path.join(ROOT, "BENCH_CORPUS.json")) as f:
        rec16 = json.load(f)["overrides"]
    reset()
    t = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        rep16 = bench_corpus_torch.main(["--sizes", "2048", "--chains", "128",
                                         "--init", "optimal"])
    counts16 = launched("bench_corpus")
    seconds16 = time.time() - t
    check(rep16["overrides"] == {k: v for k, v in rec16.items()
                                 if k != "kernel"},
          "the recorded overrides (the port has no kernel selector)")
    rows16 = {r["file"]: r for r in rep16["rows"]}
    check(list(rows16) == list(want16), f"rows {list(rows16)}")
    iters16 = 3 * 200 * 2048 // 128
    for name, (ours, xz) in want16.items():
        r = rows16[name]
        check(r["ours"]["moves"] == 1228800 and r["ours"]["decodes"],
              f"{name}: 1,228,800 moves, decodes with lzma")
        check(r["ours"]["bytes"] == ours, f"{name}: {r['ours']['bytes']} B "
              f"== the recorded {ours} B")
        check(r["xz9e"]["bytes"] == xz, f"{name}: liblzma 9e "
              f"{r['xz9e']['bytes']} B == the recorded xz -9e {xz} B")
    check(counts16 == {"log2_probe": 8, "repair_cost": 4 * (iters16 + 3),
                       "propose": 4 * (iters16 + 1), "candidates": 2 * 8},
          f"two contexts a file, one launch per iteration, two candidate "
          f"tables a context: {counts16}")
    def per_file(col: str, field: str) -> str:
        return json.dumps({k: r[col][field] for k, r in rows16.items()}
                          ).replace(" ", "")
    say("bench_corpus", n=2048, C=128, moves=1228800, tolerance=0,
        bytes=per_file("ours", "bytes"),
        liblzma_9e_bytes=per_file("xz9e", "bytes"),
        reference_recorded_bytes=per_file("reference", "bytes"),
        moves_per_s=per_file("ours", "moves_per_s"),
        file_seconds=per_file("ours", "seconds"),
        decodes=True, seconds=round(seconds16, 1),
        launches=json.dumps(counts16).replace(" ", ""))

    rows = [{"name": name, "route": "cuda", "source": k["source"],
             "replaces": k["replaces"], "launches": launches[name],
             "launches_by_path": {p: c[name] for p, c in by_path.items()},
             "max_abs_err": k["max_abs_err"], "ms": k["ms"],
             **({"staged_by_path": staged_by_path}
                if name == "repair_cost" else {}),
             "call_ms": k["call_ms"],
             "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
             "bound_by": k["bound_by"], "library_ms": k["library_ms"],
             **{x: k[x] for x in ("launch_floor_ms", "host_ms", "tables")
                if x in k}}
            for name, k in kernels.items()]
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
