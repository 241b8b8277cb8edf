"""CLI: the reference's `megalania filename` interface, on PyTorch.

`python -m megalania_tpu_torch.cli compress FILE` writes the compressed
stream to stdout (or -o) and progress to stderr; plus decompress/verify.
The anneal runs on --device: "cuda" (the default) runs the CUDA kernels
and fails when there is no card; "cpu" runs their plain PyTorch versions.
Flags of megalania_tpu's CLI that the port does not carry yet
(--platform, --distributed, --kernel, --ranker, --checkpoint*,
--resume, --metrics-jsonl) are absent.
"""
from __future__ import annotations

import argparse
import sys
import time

from .anneal.config import AnnealConfig
from . import compressor


def _progress_printer(t0):
    def cb(info):
        sys.stderr.write(
            "block %d  current file size: %.2f  iter %d/%d  epochs: %d  "
            "moves: %d  %.1f moves/s  %.1fs\n" % (
                info["block"] + 1, info["best_bytes"], info["iter"],
                info["iters"], info["epochs"], info["moves"],
                info["moves_per_sec"], time.time() - t0))
    return cb


def _write(path: str, blob: bytes):
    """Write to the file `path`, or to stdout for "-"."""
    if path == "-":
        sys.stdout.buffer.write(blob)
        sys.stdout.buffer.flush()
        return
    with open(path, "wb") as f:
        f.write(blob)


def _device(name: str):
    import torch
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("megalania_tpu_torch: --device cuda but no CUDA "
                         "device is available (use --device cpu for the "
                         "plain PyTorch path)")
    return name


def main(argv=None):
    ap = argparse.ArgumentParser(prog="megalania-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compress", help="anneal-compress a file")
    c.add_argument("file")
    c.add_argument("-o", "--output", default="-")
    c.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the anneal runs: cuda = the CUDA kernels, "
                   "cpu = their plain PyTorch versions")
    c.add_argument("--chains", type=int, default=128,
                   help="parallel annealing chains")
    c.add_argument("--chain-block", type=int, default=0,
                   help="chains per block of the sweep-tile rule (0 = "
                   "auto: widest of 512/384/256/128 dividing --chains)")
    c.add_argument("--block-size", type=int, default=1 << 16)
    c.add_argument("--moves", type=int, default=None,
                   help="total anneal moves (default: reference budget; "
                   "0 = DP-only mode, emit the --init parse directly)")
    c.add_argument("--proposals", type=int, default=1,
                   help="proposals costed per chain per pass (best-of-P)")
    c.add_argument("--top-k", type=int, default=20)
    c.add_argument("--sublens", type=int, default=3,
                   help="candidate lengths evaluated per match entry")
    c.add_argument("--init", default="optimal",
                   choices=["greedy", "literal", "mixed", "optimal",
                            "mixed_opt"],
                   help="initial parse")
    c.add_argument("--mixed-greedy-frac", type=float, default=0.5)
    c.add_argument("--opt-candidates", type=int, default=64)
    c.add_argument("--opt-walk", type=int, default=1024)
    c.add_argument("--opt-passes", type=int, default=16)
    c.add_argument("--opt-window", type=int, default=0)
    c.add_argument("--lc", type=int, default=0,
                   help="literal context bits (0..4)")
    c.add_argument("--seed", type=int, default=1673551)
    c.add_argument("--quiet", action="store_true")
    c.add_argument("--site-mode", default="byte", choices=["byte", "packet"])
    c.add_argument("--site-schedule", default="sweep",
                   choices=["sweep", "random"])
    c.add_argument("--accept", default="cooled",
                   choices=["cooled", "greedy", "mixed"])
    c.add_argument("--lrep-fallback", default="match",
                   choices=["litsrep", "match"])

    d = sub.add_parser("decompress", help="decode .lzma/.mlz")
    d.add_argument("file")
    d.add_argument("-o", "--output", default="-")

    v = sub.add_parser("verify", help="round-trip check")
    v.add_argument("original")
    v.add_argument("compressed")

    args = ap.parse_args(argv)

    if args.cmd == "compress":
        data = open(args.file, "rb").read()
        cb = args.chain_block or (
            max(d for d in (512, 384, 256, 128) if args.chains % d == 0)
            if args.chains % 128 == 0 else 128)
        if args.lc and not args.chain_block:
            cb = min(cb, 128)
        cfg = AnnealConfig(
            chains=args.chains, chain_block=cb, block_size=args.block_size,
            top_k=args.top_k, seed=args.seed, proposals=args.proposals,
            site_mode=args.site_mode, lrep_fallback=args.lrep_fallback,
            sublens=args.sublens, init=args.init,
            site_schedule=args.site_schedule, lc=args.lc,
            mixed_greedy_frac=args.mixed_greedy_frac, accept=args.accept,
            opt_candidates=args.opt_candidates, opt_walk=args.opt_walk,
            opt_passes=args.opt_passes, opt_window=args.opt_window,
        )
        device = _device(args.device)
        progress = None if args.quiet else _progress_printer(time.time())
        blob = compressor.compress(data, cfg, total_moves=args.moves,
                                   progress=progress, device=device)
        _write(args.output, blob)
        sys.stderr.write(
            "in: %d bytes  out: %d bytes  ratio: %.4f\n"
            % (len(data), len(blob), len(blob) / max(len(data), 1)))
    elif args.cmd == "decompress":
        blob = open(args.file, "rb").read()
        _write(args.output, compressor.decompress(blob))
    else:
        original = open(args.original, "rb").read()
        blob = open(args.compressed, "rb").read()
        ok = compressor.decompress(blob) == original
        print("OK" if ok else "MISMATCH")
        return 0 if ok else 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
