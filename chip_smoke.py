#!/usr/bin/env python3
"""Smoke test of megalania_tpu_torch on one CUDA card (an H100, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout, holds each against its
plain PyTorch version on the card, runs the engine on cuda and on cpu
and compares the states, then compresses a real 64 KiB block through the
port's CLI with 128 chains and checks the output.  Each phase prints one
line.  The last lines are the card's name and power limit (nvidia-smi),
a JSON object with one entry per kernel, and
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
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
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


def max_abs_diff(got, want) -> int:
    """Largest |difference| over matching output tuples (exact: 0)."""
    import torch
    worst = 0
    for g, w in zip(got, want):
        g = g.detach().to("cpu", torch.int64)
        w = w.detach().to("cpu", torch.int64)
        check(g.shape == w.shape, f"shape {tuple(g.shape)} != {tuple(w.shape)}")
        if g.numel():
            worst = max(worst, int((g - w).abs().max()))
    return worst


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device available")
    sys.path.insert(0, ROOT)
    from megalania_tpu_torch import cli, compressor
    from megalania_tpu_torch.anneal import engine, moves
    from megalania_tpu_torch.anneal.config import AnnealConfig
    from megalania_tpu_torch.match import optparse_native
    from megalania_tpu_torch.models import packets as P
    from megalania_tpu_torch.ops import (log2_cuda, rank_cuda, repair_cuda,
                                         tables as T)
    from megalania_tpu_torch.runtime import build

    os.makedirs(WORK, exist_ok=True)
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1673551)
    corpus = open(CORPUS, "rb").read()
    kernels = {
        "log2_probe": dict(source="megalania_tpu_torch/csrc/log2_probe.cu",
                           replaces="megalania_tpu/ops/pallas_repair2.py:60",
                           fn=log2_cuda.log2_probe_cuda),
        "repair_cost": dict(source="megalania_tpu_torch/csrc/repair.cu",
                            replaces="megalania_tpu/ops/pallas_repair2.py:206",
                            fn=repair_cuda.repair_cost_cuda),
        "rank_candidates": dict(source="megalania_tpu_torch/csrc/rank.cu",
                                replaces="megalania_tpu/ops/pallas_rank.py:57",
                                fn=rank_cuda.rank_cuda),
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
    regs = re.findall(r"Function properties for (\w+)|Used (\d+) registers",
                      ptxas)
    say("build", seconds=round(time.time() - t, 2),
        lib=os.path.relpath(so, ROOT),
        ptxas=";".join(r[1] for r in regs if r[1]) + " registers")

    # ---- 3. log2 probe -----------------------------------------------
    raw = log2_cuda.log2_probe_cuda(dev)
    plain = log2_cuda.log2_probe_plain(dev)
    corr = log2_cuda.build_correction(raw.cpu().numpy())
    exact = log2_cuda.apply_correction(raw.cpu().numpy(), corr)
    check(np.array_equal(exact[1:], T.LOG2_TABLE_NP[1:]),
          "probe + correction == LOG2_TABLE for p in 1..2047")
    raw_dev = int((raw.long() - plain.long()).abs().max())
    kernels["log2_probe"]["max_abs_err"] = int(
        np.abs(exact[1:] - plain.cpu().numpy()[1:]).max())
    say("log2", tolerance=0, raw_vs_table_max=raw_dev,
        corrected_vs_table_max=kernels["log2_probe"]["max_abs_err"],
        corrections=int((raw.cpu().numpy() != plain.cpu().numpy()).sum()))

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
            slab_in, q_, u_, c_.data, c_.cand_dist, c_.cand_len, c_.corr,
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
        got1[0], q2, u2, ctx.data, ctx.cand_dist, ctx.cand_len, ctx.corr,
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

    # ---- 5. rank kernel vs its plain version -------------------------
    probs = got1[3]
    qs = ti(rng.integers(0, n, C))
    rec_ctx = ti(rng.integers(0, 12, C))
    rec_dists = ti(np.sort(rng.integers(0, n - 1, (C, 4)), axis=1))
    cands = moves.enumerate_candidates(
        slabs_t, qs, rec_dists, ctx.data, ctx.rank, ctx.sparse,
        ctx.cand_dist, ctx.cand_len, ctx.cand_count)
    candp = moves.pack_candidates(cands).contiguous()
    rank_args = (probs, candp, rec_ctx, rec_dists,
                 *moves.site_bytes(ctx.data, qs, rec_dists))
    got = rank_cuda.rank_cuda(*rank_args, ctx.corr)
    want = rank_cuda.rank_plain(*rank_args)
    d = max_abs_diff([got], [want])
    check(d == 0, f"rank kernel == plain version: {d}")
    kernels["rank_candidates"]["max_abs_err"] = d
    say("rank", C=C, NC=candp.shape[1], tolerance=0, max_abs_err=d,
        valid=int((want < rank_cuda.BIG).sum()))

    # ---- 6. slice parity: the engine on cuda == on cpu ---------------
    cfg6 = AnnealConfig(chains=C, iters_per_epoch=4)
    t = time.time()
    states = {}
    for name in ("cuda", "cpu"):
        c6 = engine.make_context(block, cfg6, name)
        s = engine.run_iters(engine.init_state(c6, cfg6), c6, cfg6, 12)
        states[name] = engine.state_to_numpy(s)
    a, b = states["cuda"], states["cpu"]
    for f in a["chains"]:
        check(np.array_equal(a["chains"][f], b["chains"][f]),
              f"engine state chains.{f}: cuda == cpu")
    for f in a:
        if f != "chains":
            check(np.array_equal(a[f], b[f]), f"engine state {f}: cuda == cpu")
    say("slice", n=n, C=C, iters=12, epochs=int(a["epochs_done"]),
        identical=True, best_bytes=round(
            18 + (int(a["best_hi"]) * 65536 + int(a["best_lo"])) / 16384.0, 2),
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
    seed = compressor._seed_slab(data, AnnealConfig())
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
    full_ms = cuda_ms(
        lambda: repair_cuda.repair_cost_cuda(
            s64.chains.slab, q64, u64, c64.data, c64.cand_dist,
            c64.cand_len, c64.corr, **kw), 5)
    # kernel against plain at n=65536, C=128 on the block's last 8192
    # positions, from the kernel's own snapshot there (the plain pass
    # takes one Python step per position: minutes for the whole block),
    # with the mutation substituted in-pass as on the main path
    start64 = n64 - 8192
    snap = repair_cuda.repair_cost_cuda(
        s64.chains.slab, q64, u64, c64.data, c64.cand_dist, c64.cand_len,
        c64.corr, cap_pos=start64, **kw)
    part_args = (snap[0], ti(rng.integers(start64, n64, C)),
                 ti(rng.integers(start64, n64, C)), c64.data,
                 c64.cand_dist, c64.cand_len)
    part_kw = dict(kw, start_pos=start64, probs_in=snap[3],
                   carry_in=snap[8], mut0=mut0, mut1=mut1)
    got = repair_cuda.repair_cost_cuda(*part_args, c64.corr, **part_kw)
    torch.cuda.synchronize()
    t = time.time()
    want = repair_cuda.repair_cost_plain(*part_args, c64.log2, **part_kw)
    torch.cuda.synchronize()
    kernels["repair_cost"]["plain_ms"] = (time.time() - t) * 1e3
    d = max_abs_diff(got, want)
    check(d == 0, f"repair kernel == plain version (n={n64}, partial): {d}")
    kernels["repair_cost"]["max_abs_err"] = max(
        kernels["repair_cost"]["max_abs_err"], d)
    kernels["repair_cost"]["ms"] = cuda_ms(
        lambda: repair_cuda.repair_cost_cuda(*part_args, c64.corr,
                                             **part_kw), 20)
    ch = s64.chains
    cands = moves.enumerate_candidates(
        ch.slab, q64, ch.rec_dists, c64.data, c64.rank, c64.sparse,
        c64.cand_dist, c64.cand_len, c64.cand_count)
    candp = moves.pack_candidates(cands).contiguous()
    rank_args = (ch.rank_probs, candp, ch.rec_ctx, ch.rec_dists,
                 *moves.site_bytes(c64.data, q64, ch.rec_dists))
    d = max_abs_diff([rank_cuda.rank_cuda(*rank_args, c64.corr)],
                     [rank_cuda.rank_plain(*rank_args)])
    check(d == 0, f"rank kernel == plain version (n={n64}): {d}")
    kernels["rank_candidates"]["max_abs_err"] = max(
        kernels["rank_candidates"]["max_abs_err"], d)
    kernels["rank_candidates"]["ms"] = cuda_ms(
        lambda: rank_cuda.rank_cuda(*rank_args, c64.corr), 50)
    kernels["rank_candidates"]["plain_ms"] = cuda_ms(
        lambda: rank_cuda.rank_plain(*rank_args), 10)
    kernels["log2_probe"]["ms"] = cuda_ms(
        lambda: log2_cuda.log2_probe_cuda(dev), 50)
    kernels["log2_probe"]["plain_ms"] = cuda_ms(
        lambda: log2_cuda.log2_probe_plain(dev), 50)
    say("times", tolerance=0, repair_full_walk_ms=round(full_ms, 3),
        repair_ms=round(kernels["repair_cost"]["ms"], 3),
        repair_plain_ms=round(kernels["repair_cost"]["plain_ms"], 1),
        repair_shape=f"C={C},n={n64},positions={start64}..{n64}",
        rank_ms=round(kernels["rank_candidates"]["ms"], 4),
        rank_plain_ms=round(kernels["rank_candidates"]["plain_ms"], 3),
        rank_shape=f"C={C},NC={candp.shape[1]}",
        log2_ms=round(kernels["log2_probe"]["ms"], 4),
        log2_plain_ms=round(kernels["log2_probe"]["plain_ms"], 4))

    rows = [{"name": name, "route": "cuda", "source": k["source"],
             "replaces": k["replaces"], "launches": launches[name],
             "max_abs_err": k["max_abs_err"], "ms": k["ms"],
             "plain_ms": k["plain_ms"]} for name, k in kernels.items()]
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
