#!/usr/bin/env python3
"""Smoke test of megalania_tpu_torch on one CUDA card (an H100, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout (and prints ptxas's
registers per kernel), holds each against its plain PyTorch version on
the card, runs the engine on cuda and on cpu and compares the states,
then compresses a real 64 KiB block through the port's CLI with 128
chains and checks the output.  Phase 8 holds the proposal kernel against
its plain version at the main path's first state and times the kernels
at the main path's shapes: each kernel's own device time (the
profiler's kernel durations) and its wrapper's call time, beside their
bounds (bytes over the HBM rate, or operations over their peak, from
this run's inputs); beside the log2 correction kernel it prints the
card's launch floor (the device time of a one-element fill) and the host
time of one log2_correction call; it also times the repair kernel's full
walk per packet, and holds the repair kernel with the block's bytes in device
memory (a 256 KiB block) against its plain version; it holds the
candidate-table kernel to the numpy builder (torch.equal) at the main
path's block for both of a context's tables, the annealer's and the
seed's, and times it against numpy's host time.  Later phases drive
the other paths on the card: an interrupted and resumed 64 KiB block
against the uninterrupted one, the whole-parse cost (scan_cost) against
the native cost, the chain-sharded anneal over a one-rank NCCL group
against the single-process one, the 1 MiB corpus as 16 blocks of 64 KiB
at 512 chains in one container (tools/run_1mib_corpus_torch.py), a
64 KiB block at lc=3 that the anneal must improve
(tools/run_64k_block_torch.py), and a small container on cuda against
the same on cpu; phases 12 and 13 also hold the repair and proposal
kernels against their plain versions at their own shapes (512 chains;
lc=3 at 64 KiB).  Phase 15 runs bench_torch.py's three rows at their
full settings and phase 16 tools/bench_corpus_torch.py's four files at
the reference's move budget: the bytes must be the ones the JAX package
recorded (BENCH_r05.json, BENCH_CORPUS.json), and phase 15 holds the
repair and proposal kernels at the headline shape (n=2,048, 512
chains).  Phase 17 runs the 1 MiB deployment (lc=3, 128 chains, the DP
seed): the repair kernel reads the bytes from device memory, its first
walk must cost every chain at the host's exact cost (past 2**31), and
it must equal its plain version on every chain over the block's last
8,192 positions.  Each phase prints one line; the kernels' entry also gives
their launches on every path driven: the candidate kernel's are two per
block context under init=optimal and one under greedy or mixed.  The last
lines are the card's name and power limit (nvidia-smi), a JSON object
with one entry per kernel, and {"ok": true, "device": {...}}.  Any
failed check raises: the script then
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


def device_ms(fn, reps: int = 100, windows: int = 5,
              kernel: str = "") -> float:
    """Device milliseconds per call of fn(): the median over `windows`
    torch.profiler windows of `reps` calls each, of the summed device
    durations the profiler records (kernels and copies; with `kernel`,
    only the kernels whose name holds it).  Unlike cuda_ms, the host's
    time between launches is not counted."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and kernel in e.key)
        per_call.append(us / 1e3 / reps)
    check(min(per_call) > 0, "the profiler recorded device time")
    return statistics.median(per_call)


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


def propose_args(ctx, state, q, cfg, rec=None, **site):
    """(args, keywords) of the proposal stage for the chains of an engine
    state at sites q (rec: their (rec_ctx, rec_dists), else the
    state's)."""
    ch = state.chains
    rec_ctx, rec_dists = rec if rec is not None else (ch.rec_ctx,
                                                      ch.rec_dists)
    return ((ch.key, state.skey, ch.slab, q, rec_ctx, rec_dists,
             ch.rank_probs, ch.live_count, ctx),
            dict(proposals=cfg.proposals, top_k=cfg.top_k,
                 sublens=cfg.sublens, lc=cfg.lc, **site))


def propose_both(*a, **kw):
    """The proposal kernel's and its plain version's outputs on the same
    CUDA tensors (propose_args' arguments)."""
    import torch
    from megalania_tpu_torch.ops import propose_cuda
    args, pkw = propose_args(*a, **kw)
    got = propose_cuda.propose_cuda(*args, **pkw)
    want = propose_cuda.propose_plain(*args, **pkw)
    torch.cuda.synchronize()
    return got, want


def max_abs_diff(got, want):
    """Largest |difference| over matching output tuples (exact: 0)."""
    import torch
    worst = 0
    for g, w in zip(got, want):
        as_ = torch.float64 if g.is_floating_point() else torch.int64
        g = g.detach().to("cpu", as_)
        w = w.detach().to("cpu", as_)
        check(g.shape == w.shape, f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            worst = max(worst, (g - w).abs().max().item())
    return worst


def first_proposal(ctx, state, cfg):
    """(sites, (rec_ctx, rec_dists), site keywords) of the proposal stage
    of the main path's first iteration from a fresh state: a fresh sweep
    (sites and stack from the zero carry where a chain's recorded site
    ran off the end), stratum 0."""
    import torch
    from megalania_tpu_torch.anneal import engine
    ch = state.chains
    n = ctx.data.shape[0]
    fresh = ch.rec_live >= n
    rec = (torch.where(fresh, 0, ch.rec_ctx),
           torch.where(fresh[:, None], 0, ch.rec_dists))
    return (torch.where(fresh, 0, ch.rec_live), rec,
            dict(u_lo=0, span=engine.choose_tile(n, cfg.chain_block, cfg.lc)))


def repair_rows(ctx, cfg, state, rows, window: int, rng) -> int:
    """The repair kernel against its plain version at a main-path shape:
    the kernel at full width (every chain of `state`, so every wave of
    blocks) from its own snapshot `window` positions before the block's
    end, with a mutation substituted in-pass at random sites in the
    window; the plain version (one Python step per position) on `rows`
    of the same inputs.  Returns the largest |difference| over every
    output of those rows (exact: 0)."""
    import numpy as np
    import torch
    from megalania_tpu_torch.models import packets as P
    from megalania_tpu_torch.ops import repair_cuda
    slab = state.chains.slab
    C, n = slab.shape
    dev = slab.device

    def ti(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)
    kw = dict(site_mode=cfg.site_mode, lrep_fallback=cfg.lrep_fallback,
              lc=cfg.lc)
    tabs = (ctx.cand_dist, ctx.cand_len, ctx.log2)
    start = n - window
    snap = repair_cuda.repair_cost_cuda(
        slab, ti(rng.integers(0, n, C)), ti(rng.integers(0, n, C)),
        ctx.data_u8, *tabs, cap_pos=start, **kw)
    q, u = ti(rng.integers(start, n, C)), ti(rng.integers(start, n, C))
    mut0 = ti(P.pack_np(P.SREP, np.zeros(C, np.int64), np.ones(C, np.int64))
              .view(np.int32))
    mut1 = ti(P.pack_np(P.LREP, rng.integers(0, 4, C), np.full(C, 2))
              .view(np.int32))
    got = repair_cuda.repair_cost_cuda(
        snap[0], q, u, ctx.data_u8, *tabs, mut0=mut0, mut1=mut1,
        start_pos=start, probs_in=snap[3], carry_in=snap[8], **kw)
    r = torch.as_tensor(rows, device=dev)
    want = repair_cuda.repair_cost_plain(
        snap[0][r], q[r], u[r], ctx.data, *tabs, mut0=mut0[r], mut1=mut1[r],
        start_pos=start, probs_in=snap[3][r], carry_in=snap[8][r], **kw)
    torch.cuda.synchronize()
    return max_abs_diff(tuple(g[r] for g in got), want)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    sys.path.insert(0, ROOT)

    from megalania_tpu_torch import cli, compressor
    from megalania_tpu_torch.anneal import engine
    from megalania_tpu_torch.anneal.config import AnnealConfig
    from megalania_tpu_torch.match import candidates as C_
    from megalania_tpu_torch.match import optparse_native
    from megalania_tpu_torch.match.suffix import build_lce
    from megalania_tpu_torch.models import packets as P
    from megalania_tpu_torch.ops import (candidates_cuda, log2_cuda,
                                         problayout, propose_cuda,
                                         repair_cuda, tables as T)
    from megalania_tpu_torch.runtime import build
    from megalania_tpu_torch.utils import fixedpoint as fp

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

    # ---- 3. log2 correction kernel vs its plain version ---------------
    table = torch.as_tensor(T.LOG2_TABLE_I32, device=dev)
    corr, raw, status = log2_cuda.log2_correction_cuda(table)
    want = log2_cuda.correction_plain(raw, table)
    words_err = int((corr.long() - want.long()).abs().max())
    check(words_err == 0, "correction kernel words == plain version's "
          f"on the kernel's raw ({words_err})")
    plain = log2_cuda.log2_probe_plain(dev)
    exact = log2_cuda.apply_correction(raw.cpu().numpy(), corr.cpu().numpy())
    check(np.array_equal(exact[1:], T.LOG2_TABLE_NP[1:]),
          "raw + correction == LOG2_TABLE for p in 1..2047")
    diff = plain.long() - raw.long()
    check(status.tolist() == [int(diff.min()), int(diff.max())],
          f"status {status.tolist()} == range of table - raw")
    same = torch.nonzero(table[1:] == raw[1:]).flatten()
    bad = table.clone()
    bad[1 + int(same[700])] += 2
    for fn, args in ((log2_cuda.log2_correction_cuda, (bad,)),
                     (log2_cuda.correction_plain, (raw, bad))):
        try:
            fn(*args)
            check(False, f"{fn.__name__} raises on a deviation of 2")
        except RuntimeError as e:
            check("deviates by >1" in str(e), f"{fn.__name__}: {e}")
    kernels["log2_probe"]["max_abs_err"] = max(words_err, int(
        np.abs(exact[1:] - plain.cpu().numpy()[1:]).max()))
    say("log2", tolerance=0, words_vs_plain_max=words_err,
        raw_vs_table_max=int(diff.abs().max()),
        corrected_vs_table_max=kernels["log2_probe"]["max_abs_err"],
        corrections=int((diff != 0).sum()), status=status.tolist(),
        raises_beyond_one=True)

    # ---- 4. repair kernel vs its plain version, both on the card -----
    n, C = 2048, 128
    block = corpus[16384:16384 + n]
    cfg = AnnealConfig(chains=C)
    ctx = engine.make_context(block, cfg, dev)
    tile = engine.choose_tile(n, 128, 0)
    check(tile == 256, f"choose_tile(2048, 128, 0) == 256, got {tile}")
    init = P.to_u32(ctx.init_slab)
    slabs = np.broadcast_to(init, (C, n)).copy()
    cd, cl = ctx.cand_dist.cpu().numpy(), ctx.cand_len.cpu().numpy()
    for c in range(C):
        for _ in range(6):
            i = int(rng.integers(2, n - 4))
            m = int(rng.integers(0, cd.shape[1]))
            if cl[i, m] >= 2:
                slabs[c, i] = P.pack_np(P.MATCH, cd[i, m],
                                        min(int(cl[i, m]), n - i))
            slabs[c, int(rng.integers(1, n))] = P.pack_np(
                P.LREP, int(rng.integers(0, 4)), 2)
            slabs[c, int(rng.integers(1, n))] = P.pack_np(P.SREP, 0, 1)
    slabs_t = P.from_u32(slabs, dev)

    def ti(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=dev)
    q = ti(rng.integers(0, n // 2, C))
    u = ti(rng.integers(0, n, C))

    def both(slab_in, q_, u_, lc=0, **kw):
        c_ = ctx if lc == 0 else lc_ctx
        got = repair_cuda.repair_cost_cuda(
            slab_in, q_, u_, c_.data_u8, c_.cand_dist, c_.cand_len, c_.log2,
            lc=lc, lrep_fallback="match", **kw)
        want = repair_cuda.repair_cost_plain(
            slab_in, q_, u_, c_.data, c_.cand_dist, c_.cand_len, c_.log2,
            lc=lc, lrep_fallback="match", **kw)
        torch.cuda.synchronize()
        return got, want

    lc_ctx = engine.make_context(block, AnnealConfig(chains=C, lc=3), dev)
    worst = 0
    q_last = q.clone()
    q_last[0] = n - 1
    mut0 = ti(P.pack_np(P.SREP, np.zeros(C, np.int64), np.ones(C, np.int64))
              .view(np.int32))
    mut1 = ti(P.pack_np(P.LREP, rng.integers(0, 4, C), np.full(C, 2))
              .view(np.int32))
    got1, want1 = both(slabs_t, q, u, cap_pos=512)
    q2 = ti(rng.integers(768, n, C))
    u2 = ti(rng.integers(512, n, C))
    cases = {
        "full_walk": both(slabs_t, q, u),
        "substitution": both(slabs_t, q_last, u, mut0=mut0, mut1=mut1),
        "capture_512": (got1, want1),
        "partial_from_512": both(got1[0], q2, u2, start_pos=512,
                                 cap_pos=768, probs_in=got1[3],
                                 carry_in=got1[8]),
        "packet_sites": both(slabs_t, q, ti(rng.integers(0, 64, C)),
                             site_mode="packet"),
        "lc3": both(slabs_t, q, u, lc=3),
    }
    for name, (got, want) in cases.items():
        d = max_abs_diff(got, want)
        check(d == 0, f"repair kernel == plain version ({name}): {d}")
        worst = max(worst, d)
    # the partial re-cost equals the full walk it replaces
    full2 = repair_cuda.repair_cost_cuda(
        got1[0], q2, u2, ctx.data_u8, ctx.cand_dist, ctx.cand_len, ctx.log2,
        lrep_fallback="match")
    part2 = cases["partial_from_512"][0]
    check(max_abs_diff(part2[:3], full2[:3]) == 0
          and max_abs_diff(part2[4:8], full2[4:8]) == 0,
          "partial re-cost from the snapshot == full walk")
    kernels["repair_cost"]["max_abs_err"] = worst
    say("repair", n=n, C=C, tile=tile, cases=len(cases), tolerance=0,
        max_abs_err=worst,
        cost_bytes_chain0=round(18 + (int(want1[1][0]) * 65536
                                      + int(want1[2][0])) / 16384.0, 2))

    # ---- 5. proposal kernel vs its plain version ---------------------
    # C=8 chains of the 2 KiB block at lc=3 with two proposals each: the
    # initial state, the same with uniform probabilities (tied metrics)
    # and the state after three iterations, at each kind of site
    cfg5 = AnnealConfig(chains=8, lc=3, proposals=2, iters_per_epoch=4)
    s5 = engine.init_state(lc_ctx, cfg5)
    states5 = {
        "init": s5,
        "uniform": s5._replace(chains=s5.chains._replace(
            rank_probs=torch.full_like(s5.chains.rank_probs, T.PROB_INIT))),
        "iterated": engine.run_iters(s5, lc_ctx, cfg5, 3)}
    q5 = ti(rng.integers(0, n, 8))
    q5[0], q5[1] = n - 1, 0
    sites5 = {"sweep": dict(u_lo=512, span=256), "byte": dict(span=n),
              "packet": dict(span=None)}
    worst = 0
    for sname, st in states5.items():
        for site_name, site in sites5.items():
            got, want = propose_both(lc_ctx, st, q5, cfg5, **site)
            d = max_abs_diff(got, want)
            check(d == 0, f"proposal kernel == plain version ({sname}, "
                  f"{site_name}): {d}")
            worst = max(worst, d)
    kernels["propose"]["max_abs_err"] = worst
    say("propose", n=n, C=8, proposals=2, lc=3, NC=want[6].shape[1],
        cases=len(states5) * len(sites5), tolerance=0, max_abs_err=worst,
        valid=int((want[6] < propose_cuda.BIG).sum()))

    # ---- 6. slice parity: the engine on cuda == on cpu ---------------
    # lc=0 at 128 chains; the lc=3 twin at 8 chains (its plain side takes
    # ~90 s of host Python at 128)
    for lc, C6 in ((0, C), (3, 8)):
        cfg6 = AnnealConfig(chains=C6, iters_per_epoch=4, lc=lc)
        t = time.time()
        states = {}
        for name in ("cuda", "cpu"):
            c6 = engine.make_context(block, cfg6, name)
            s = engine.run_iters(engine.init_state(c6, cfg6), c6, cfg6, 12)
            states[name] = engine.state_to_numpy(s)
        a, b = states["cuda"], states["cpu"]
        same_state(a, b, f"engine state cuda == cpu (lc={lc})")
        say("slice", n=n, C=C6, lc=lc, iters=12,
            epochs=int(a["epochs_done"]), identical=True,
            best_bytes=round(18 + (int(a["best_hi"]) * 65536
                                   + int(a["best_lo"])) / 16384.0, 2),
            seconds=round(time.time() - t, 1))

    # ---- 7. the main path through the CLI ----------------------------
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
    seed, _ = compressor._seed_slab(data, AnnealConfig())
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

    # ---- 8. the main-path shapes: equality and times -----------------
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
    # kernel against plain at n=65536, C=128 on the block's last 8192
    # positions, from the kernel's own snapshot there (the plain pass
    # takes one Python step per position: minutes for the whole block),
    # with the mutation substituted in-pass as on the main path
    start64 = n64 - 8192
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
    kernels["repair_cost"]["max_abs_err"] = max(
        kernels["repair_cost"]["max_abs_err"], d)
    kernels["repair_cost"]["ms"] = device_ms(
        lambda: repair64(*part_args, **part_kw), 20, 3,
        kernel="repair_kernel")
    kernels["repair_cost"]["call_ms"] = cuda_ms(
        lambda: repair64(*part_args, **part_kw), 20)
    part_bytes, part_ops, part_pk = repair_work(
        part_args[0], part_args[1], got[0], start64, M64, PR,
        mut=(mut0, mut1))
    kernels["repair_cost"]["bound_ms"], kernels["repair_cost"][
        "bound_by"] = bound(part_bytes, part_ops, I32_OPS_PER_S)
    say("repair_times", tolerance=0, full_walk_ms=full_ms,
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

    # the same kernel with the block's bytes in device memory: a block
    # too large for shared memory, the plain version on its last 2048
    # positions from the kernel's own snapshot
    nbig, Cg = 262144, 8
    check(not repair_cuda.staging_plan(nbig, 0).bytes_in_smem,
          f"a {nbig}-byte block reads its bytes from device memory")
    cfgg = AnnealConfig(chains=Cg)
    t = time.time()
    cg = engine.make_context(corpus[:nbig], cfgg, dev)
    ctx_s = time.time() - t
    sg = engine.init_state(cg, cfgg)
    startg = nbig - 2048

    def repairg(slab_in, q_, u_, **kw_):
        return repair_cuda.repair_cost_cuda(
            slab_in, q_, u_, cg.data_u8, cg.cand_dist, cg.cand_len,
            cg.log2, **kw, **kw_)
    qg, ug = ti(rng.integers(0, nbig, Cg)), ti(rng.integers(0, nbig, Cg))
    fullg_ms = cuda_ms(lambda: repairg(sg.chains.slab, qg, ug), 3)
    snapg = repairg(sg.chains.slab, qg, ug, cap_pos=startg)
    gargs = (snapg[0], ti(rng.integers(startg, nbig, Cg)),
             ti(rng.integers(startg, nbig, Cg)))
    gkw = dict(start_pos=startg, probs_in=snapg[3], carry_in=snapg[8],
               mut0=mut0[:Cg], mut1=mut1[:Cg])
    got = repairg(*gargs, **gkw)
    want = repair_cuda.repair_cost_plain(
        *gargs, cg.data, cg.cand_dist, cg.cand_len, cg.log2, **kw, **gkw)
    torch.cuda.synchronize()
    d = max_abs_diff(got, want)
    check(d == 0, f"repair kernel, bytes in device memory == plain "
          f"version (n={nbig}, partial): {d}")
    kernels["repair_cost"]["max_abs_err"] = max(
        kernels["repair_cost"]["max_abs_err"], d)
    fullg_pk = repair_work(sg.chains.slab, qg,
                           repairg(sg.chains.slab, qg, ug)[0], 0,
                           cg.cand_dist.shape[1], PR)[2]
    say("repair_global", n=nbig, C=Cg, tolerance=0, max_abs_err=d,
        positions=f"{startg}..{nbig}", context_seconds=round(ctx_s, 1),
        full_walk_ms=fullg_ms, packets_per_chain_max=int(fullg_pk.max()),
        ns_per_packet_per_chain=fullg_ms * 1e6 / int(fullg_pk.max()))


    # the proposal stage of the main path's first iteration
    q8, rec8, site8 = first_proposal(c64, s64, cfg8)
    pargs, pkw = propose_args(c64, s64, q8, cfg8, rec=rec8, **site8)
    got, want = propose_both(c64, s64, q8, cfg8, rec=rec8, **site8)
    d = max_abs_diff(got, want)
    check(d == 0, f"proposal kernel == plain version (n={n64}, C={C}): {d}")
    kernels["propose"]["max_abs_err"] = max(
        kernels["propose"]["max_abs_err"], d)
    kernels["propose"]["ms"] = device_ms(
        lambda: propose_cuda.propose_cuda(*pargs, **pkw),
        kernel="propose_kernel")
    kernels["propose"]["call_ms"] = cuda_ms(
        lambda: propose_cuda.propose_cuda(*pargs, **pkw), 50)
    kernels["propose"]["plain_ms"] = cuda_ms(
        lambda: propose_cuda.propose_plain(*pargs, **pkw), 5)
    NC = want[6].shape[1]
    # the correction kernel on the main path's table (one launch per
    # block context), beside the card's launch floor: the device time of
    # a one-element fill
    table64 = c64.log2
    _, raw64, _ = log2_cuda.log2_correction_cuda(table64)
    kernels["log2_probe"]["ms"] = device_ms(
        lambda: log2_cuda.log2_correction_cuda(table64),
        kernel="log2_correction")
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
            ms=device_ms(cand, 20, 5, kernel="candidates_kernel"),
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

    def reset():
        for k in kernels.values():
            k["fn"].launches = 0

    by_path = {"main_path": launches}

    def launched(path: str, tables: int | None = 2) -> dict:
        """The launches since reset(); `tables`: candidate tables a
        context (one log2 correction each), 2 under init=optimal, 1
        under greedy or mixed, None where the inits are mixed."""
        counts = {name: k["fn"].launches for name, k in kernels.items()}
        for name, cnt in counts.items():
            check(cnt > 0, f"{name} launched on the {path} path ({cnt})")
        if tables is not None:
            check(counts["candidates"] == tables * counts["log2_probe"],
                  f"{tables} candidate table(s) a context on the {path} "
                  f"path: {counts}")
        by_path[path] = counts
        return counts

    # ---- 9. checkpoint/resume at 64 KiB, C=128 ------------------------
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

    # ---- 10. whole-parse cost on the card -----------------------------
    from megalania_tpu_torch.ops import scan_cost
    t = time.time()
    seed2k = ctx.init_slab
    chains4 = cases["full_walk"][0][0][:4].contiguous()
    got10 = [scan_cost.parse_cost_exact(seed2k, ctx.data)]
    got10.append(scan_cost.parse_cost_exact(chains4, ctx.data))
    arr2k = np.frombuffer(block, np.uint8)
    want10 = [optparse_native.cost_train(arr2k, P.to_u32(s))[0]
              for s in [seed2k, *chains4]]
    costs10 = ([int(got10[0][0]) * 65536 + int(got10[0][1])]
               + [int(h) * 65536 + int(lo_)
                  for h, lo_ in zip(got10[1][0].cpu(), got10[1][1].cpu())])
    check(costs10 == want10, f"scan_cost {costs10} == cost_train {want10}")
    check(got10[1][3].is_cuda and bool(got10[1][3].any()),
          "scan_cost ran on the card and marked live packets")
    say("scan_cost", n=n, parses=len(want10), tolerance=0, equal=True,
        seed_bytes=round(18 + want10[0] / 16384.0, 2),
        seconds=round(time.time() - t, 1))

    # ---- 11. chain sharding over a one-rank NCCL group ----------------
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
        s11 = mesh_mod.sharded_run(s11, c11, cfg11, 8, m)
        counts11 = launched("distributed", 1)
        ref11 = engine.run_iters(engine.init_state(c11, cfg11), c11, cfg11,
                                 8)
        same_state(engine.state_to_numpy(s11), engine.state_to_numpy(ref11),
                   "sharded_run over NCCL == run_iters")
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

    # ---- 12. the 1 MiB corpus: 16 blocks of 64 KiB at 512 chains -------
    # the scale runner tools/run_1mib_corpus_torch.py through
    # compressor.compress: one context, one log2 correction and 64
    # iterations per block (the main path's 32,768 moves), one container
    from megalania_tpu_torch.parallel import blocks as blocks_mod
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
    # the repair and proposal kernels against their plain versions at
    # this phase's shapes, on block 0 at 512 chains: the repair kernel's
    # two waves (rows of both compared), the first iteration's 512
    # proposal rows
    c12 = engine.make_context(data12[:65536], cfg12, dev)
    s12 = engine.init_state(c12, cfg12)
    rows12 = [*range(8), *range(C12 - 8, C12)]
    rep12 = repair_rows(c12, cfg12, s12, rows12, 4096, rng)
    q12, rec12, site12 = first_proposal(c12, s12, cfg12)
    prop12 = max_abs_diff(*propose_both(c12, s12, q12, cfg12, rec=rec12,
                                        **site12))
    check(rep12 == 0 and prop12 == 0, f"repair ({rep12}) and proposal "
          f"({prop12}) kernels == plain versions at C={C12}, n=65536")
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
        launches=json.dumps(counts12).replace(" ", ""), tolerance=0,
        repair_max_abs_err=rep12,
        repair_rows_held=f"0..7,{C12 - 8}..{C12 - 1}",
        repair_positions=f"{65536 - 4096}..65536",
        propose_max_abs_err=prop12, propose_rows=C12,
        propose_span=site12["span"])

    # ---- 13. a 64 KiB block at lc=3 through the 64 KiB runner ---------
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
    # the kernels against their plain versions at lc=3, n=65,536 (129,808
    # B of shared memory per chain) from the initial state
    rep13 = repair_rows(c13, cfg13, s13, [0, 1, 2, 3, 124, 125, 126, 127],
                        4096, rng)
    q13, rec13, site13 = first_proposal(c13, s13, cfg13)
    prop13 = max_abs_diff(*propose_both(c13, s13, q13, cfg13, rec=rec13,
                                        **site13))
    check(rep13 == 0 and prop13 == 0, f"repair ({rep13}) and proposal "
          f"({prop13}) kernels == plain versions at lc=3, n=65536")
    # a second witness of the improvement: the same 256 iterations from
    # the same initial state end at the runner's best, and the host's
    # exact cost (optparse_native.cost_train, no code shared with the
    # card) of the first and the final best parse equals the card's
    arr13 = np.frombuffer(data13, np.uint8)
    host13 = [optparse_native.cost_train(arr13, P.to_u32(s13.best_slab),
                                         lc=3)[0]]
    card13 = [fp.to_int(s13.best_hi, s13.best_lo)]
    end13 = engine.run_iters(s13, c13, cfg13, iters13)
    check(engine.best_cost_bytes(end13) == res13["predicted"],
          "run_iters from the initial state ends at the runner's best")
    host13.append(optparse_native.cost_train(
        arr13, P.to_u32(end13.best_slab), lc=3)[0])
    card13.append(fp.to_int(end13.best_hi, end13.best_lo))
    check(host13 == card13 and host13[1] < host13[0],
          f"host cost of the first and final best {host13} == the card's "
          f"{card13}, and falls")
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
        launches=json.dumps(counts13).replace(" ", ""),
        host_cost=f"{host13[0]}->{host13[1]}", host_cost_equal=True,
        tolerance=0, repair_max_abs_err=rep13,
        repair_rows_held="0..3,124..127",
        repair_positions=f"{65536 - 4096}..65536",
        propose_max_abs_err=prop13, propose_span=site13["span"])
    for name, d in (("repair_cost", max(rep12, rep13)),
                    ("propose", max(prop12, prop13))):
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], d)

    # ---- 14. a small container, cuda == cpu ---------------------------
    # four 2 KiB blocks and a tail through compressor.compress, 8 chains,
    # 3 iterations per block: the many-block orchestration itself
    data14 = corpus[32768:32768 + 4 * 2048 + 700]
    cfg14, moves14 = AnnealConfig(chains=8, block_size=2048), 5 * 3 * 8
    reset()
    t = time.time()
    got14 = compressor.compress(data14, cfg14, total_moves=moves14,
                                device=dev)
    cuda14_s = time.time() - t
    counts14 = launched("container")
    t = time.time()
    want14 = compressor.compress(data14, cfg14, total_moves=moves14,
                                 device="cpu")
    cpu14_s = time.time() - t
    check(got14 == want14, "container bytes cuda == cpu")
    check(len(blocks_mod.unpack_container(got14)) == 5
          and compressor.decompress(got14) == data14,
          "the container holds 5 streams and decodes")
    say("container", n=len(data14), blocks=5, block_size=2048, C=8,
        iters_per_block=moves14 // 5 // 8, bytes=len(got14),
        identical=True, cuda_seconds=round(cuda14_s, 1),
        cpu_seconds=round(cpu14_s, 1),
        launches=json.dumps(counts14).replace(" ", ""))

    # ---- 15. bench: bench_torch.py's three rows at full settings -------
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
    # the kernels against their plain versions at the headline shape
    # (n=2,048, 512 chains: two waves): the first iteration's 512
    # proposal rows, and the repair kernel on rows 0-7 and 504-511 over
    # the last 1,024 positions, at the initial state and after 40
    # iterations (past the first sweep cycle)
    cfg15 = AnnealConfig(chains=C15, chain_block=bench_torch.chain_block(C15),
                         init="mixed", accept="cooled")
    c15 = engine.make_context(bench_torch.corpus(bench_torch.N), cfg15, dev)
    s15 = engine.init_state(c15, cfg15)
    q15, rec15, site15 = first_proposal(c15, s15, cfg15)
    prop15 = max_abs_diff(*propose_both(c15, s15, q15, cfg15, rec=rec15,
                                        **site15))
    rows_held15 = [*range(8), *range(C15 - 8, C15)]
    mid15 = engine.run_iters(s15, c15, cfg15, 40)
    rep15 = max(repair_rows(c15, cfg15, st, rows_held15, 1024, rng)
                for st in (s15, mid15))
    check(rep15 == 0 and prop15 == 0, f"repair ({rep15}) and proposal "
          f"({prop15}) kernels == plain versions at C={C15}, n=2048")
    # where an iteration's time goes at the headline shape: its device
    # time (profiler) against its wall time (host clock around 64
    # iterations ending in a synchronize), from the state after 40
    held = [mid15]

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
    say("bench", C=C15, chain_block=cfg15.chain_block, tolerance=0,
        **{f"{key}_{f}": rows15[key][f] for key in rows15
           for f in ("best_bytes", "best_cost", "moves_per_s", "seconds",
                     "row_seconds")},
        headline_best="%.2f" % rows15["headline"]["best_bytes"],
        design_point_best="%.2f" % rows15["design_point"]["best_bytes"],
        headline_device_ms_per_iter=dev15, headline_wall_ms_per_iter=wall15,
        headline_busy_share=dev15 / wall15,
        rows_seconds=round(rows_seconds15, 1), seconds=round(seconds15, 1),
        launches=json.dumps(counts15).replace(" ", ""),
        repair_max_abs_err=rep15,
        repair_rows_held=f"0..7,{C15 - 8}..{C15 - 1}",
        repair_positions=f"{bench_torch.N - 1024}..{bench_torch.N}",
        propose_max_abs_err=prop15, propose_rows=C15,
        propose_span=site15["span"])

    # ---- 16. bench_corpus: the four corpus files at the reference budget
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
    for name, d in (("repair_cost", rep15), ("propose", prop15)):
        kernels[name]["max_abs_err"] = max(kernels[name]["max_abs_err"], d)

    # ---- 17. the 1 MiB deployment ------------------------------------
    # compress --block-size 1048576 --lc 3: 128 chains from the DP seed,
    # the bytes in device memory; the first full walk costs every chain
    # at the host's exact cost (past 2**31), and the kernel equals the
    # plain version on every chain over the block's last 8,192 positions
    n1m = P.MAX_BLOCK
    cfg1m = AnnealConfig(chains=128, chain_block=cli.chain_block(128, 3),
                         lc=3, block_size=n1m)
    check(not repair_cuda.staging_plan(n1m, 3).bytes_in_smem,
          "a 1 MiB block reads its bytes from device memory")
    t = time.time()
    c1m = engine.make_context(corpus[:n1m], cfg1m, dev)
    ctx1m_s = time.time() - t
    staged = dict(repair_cuda.repair_cost_cuda.staged)
    t = time.time()
    s1m = engine.init_state(c1m, cfg1m)
    torch.cuda.synchronize()
    init1m_s = time.time() - t
    host1m = optparse_native.cost_train(
        np.frombuffer(corpus[:n1m], np.uint8), P.to_u32(c1m.init_slab),
        lc=3)[0]
    card1m = {fp.to_int(h, lo) for h, lo in zip(
        s1m.chains.cost_hi.tolist(), s1m.chains.cost_lo.tolist())}
    check(card1m == {host1m} and host1m > 1 << 31,
          f"1 MiB first walk: card {sorted(card1m)[:3]} == host {host1m}")
    d = repair_rows(c1m, cfg1m, s1m, list(range(128)), 8192, rng)
    check(d == 0, f"repair kernel == plain version at n={n1m}, lc=3: {d}")
    kernels["repair_cost"]["max_abs_err"] = max(
        kernels["repair_cost"]["max_abs_err"], d)
    now = repair_cuda.repair_cost_cuda.staged
    check((now["device"] - staged["device"], now["shared"]) == (
        3, staged["shared"]), f"1 MiB launches in device memory: {now}")
    say("repair_1m", n=n1m, C=128, lc=3, tolerance=0, max_abs_err=d,
        positions=f"{n1m - 8192}..{n1m}", seed_cost=host1m,
        context_seconds=round(ctx1m_s, 1), init_state_seconds=round(
            init1m_s, 2), staged=dict(now))

    rows = [{"name": name, "route": "cuda", "source": k["source"],
             "replaces": k["replaces"], "launches": launches[name],
             "launches_by_path": {p: c[name] for p, c in by_path.items()},
             "max_abs_err": k["max_abs_err"], "ms": k["ms"],
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
