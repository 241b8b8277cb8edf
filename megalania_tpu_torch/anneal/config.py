"""Annealer configuration.

Every compile-time constant of the reference program becomes a field here
(reference values cited from the reference's src/main.c:45-99,
packet_slab_neighbour.c:64-65, packet_enumerator.c:6-7).

Same fields and defaults as megalania_tpu.anneal.config, minus the
kernel/ranker selectors: the port dispatches on the tensors' device
(CUDA kernels on `cuda`, plain PyTorch on `cpu`), so there is nothing
to select.
"""
from __future__ import annotations

import dataclasses

# blocks beyond the packed format's 1 MiB (annealable) cap would run the
# host-side wide-distance optimum-parse pipeline, which the port does not
# carry yet (compressor raises NotImplementedError)
MAX_WIDE_BLOCK = 64 << 20


@dataclasses.dataclass(frozen=True)
class AnnealConfig:
    # LZMA properties (reference: lc=lp=pb=0, main.c:45).  lc>0 (literal
    # context bits of the previous byte, xz's default is lc=3) is a ratio
    # lever on text the reference binary lacks entirely.
    lc: int = 0
    lp: int = 0
    pb: int = 0
    dict_size: int = 0x400000          # header field (lzma_header_encoder.c:16)

    # schedule (reference: 3 steps x 200 epochs x n iters, main.c:66-69)
    num_steps: int = 3
    num_epochs: int = 200              # reference epochs; chains divide this
    # lockstep iterations per epoch-restart.  The reference restarts
    # every n MOVES (main.c:70); with C lockstep chains an epoch of
    # 16n/C iterations reseeds from the global best every ~16n moves.
    # None = this scaled default; a block length n is the once-per-budget
    # behavior (iters_per_epoch=n).
    iters_per_epoch: int | None = None

    # proposal distribution
    top_k: int = 20                    # beam size (main.c:49)
    bias_draws: int = 8                # max-of-8 draw bias (neighbour.c:64)
    force_best_prob: float = 0.125     # 1/8 forced best (neighbour.c:65)
    boundary_prob: float = 0.5         # boundary-move coin (neighbour.c:122)

    # candidate tables (dense Pareto tables, match/candidates.py)
    max_candidates: int = 16
    max_walk: int = 96
    sublens: int = 3                   # lengths evaluated per candidate
    # optimum-parse initializer (native Viterbi, match/optparse_native):
    # the DP is host-side, so it affords a much wider Pareto table than
    # the anneal kernels carry, plus dense 2..273 length enumeration.
    opt_candidates: int = 64
    opt_walk: int = 1024
    opt_passes: int = 16
    opt_window: int = 0      # 0 = sweep {256, 512, 1024}, keep best
    # initial parse: "greedy" (longest-match walk over the candidate
    # table), "literal" (the reference's all-literals, main.c:71),
    # "mixed" (greedy/literal chain split), "optimal" (price-driven
    # shortest-path DP, match/optparse.py; the annealer becomes a strict
    # refiner), or "mixed_opt" (optimal/literal chain split).
    init: str = "optimal"
    # fraction of chains seeded from the greedy parse under init="mixed"
    # (rounded to eighths; the rest start all-literals)
    mixed_greedy_frac: float = 0.5

    # acceptance rule: "cooled" = the reference's cooling transition
    # (accept-worse w.p. ~ sqrt(iters)/(i^2+...), main.c:86); "greedy" =
    # accept only strict improvements; "mixed" = an acceptance race —
    # even global chain ids run cooled, odd run greedy, sharing one
    # global best.
    accept: str = "cooled"

    # parallel structure
    chains: int = 64                   # parallel annealing chains per block
    proposals: int = 1                 # proposals costed per chain per pass
    #   (best-of-P before acceptance; the reference costs 1, main.c:78)
    block_size: int = 1 << 16          # block sharding unit (<= 1 MiB)

    # mutation-site distribution: "byte" picks a byte position (site =
    # containing/following live packet, weights by preceding length);
    # "packet" picks uniformly over live packets, the reference's rule
    # (packet_slab_neighbour.c:162-163), using the previous pass's count
    site_mode: str = "byte"
    # mutation-site schedule: "sweep" samples the recording site from a
    # low-to-high tile-stratified sweep SHARED by all chains, enabling
    # partial re-cost (each pass restarts from a coder-state snapshot at
    # the last tile boundary before the previous site); "random" is the
    # independent per-chain uniform site draw (always a full walk from
    # 0).  site_mode="packet" forces "random".
    site_schedule: str = "sweep"
    # passes spent in each sweep stratum before advancing
    sweep_repeats: int = 4
    # repair fallback for an un-re-aimable long rep: "match" (best table
    # match at the site) or "litsrep" (plain literal/short-rep)
    lrep_fallback: str = "match"
    # chains per block of the schedule's tile rule (engine.choose_tile):
    # it sets the sweep strata, so it is part of the trajectory
    chain_block: int = 128

    seed: int = 1673551                # reference seed (main.c:68)

    def __post_init__(self):
        if not (0 <= self.lc <= 4):
            raise ValueError("lc must be in 0..4")
        if self.lp != 0 or self.pb != 0:
            raise ValueError("only lp=pb=0 is implemented (like the "
                             "reference, main.c:45)")
        if not (0 < self.block_size <= MAX_WIDE_BLOCK):
            raise ValueError(
                f"block_size={self.block_size} exceeds the "
                f"{MAX_WIDE_BLOCK}-byte wide-pipeline limit")
        if self.chains < 1:
            raise ValueError("chains must be >= 1")
        if self.proposals < 1:
            raise ValueError("proposals must be >= 1")
        if not (1 <= self.sublens <= 10):
            raise ValueError("sublens must be in 1..10 (moves._sublens)")
        if min(self.opt_candidates, self.opt_walk, self.opt_passes) < 1:
            raise ValueError("opt_* fields must be >= 1")
        if self.opt_window < 0:
            raise ValueError("opt_window must be >= 0 (0 = auto sweep)")
        if self.chain_block % 8 != 0:
            raise ValueError("chain_block must be a multiple of 8")
        if self.site_mode not in ("byte", "packet"):
            raise ValueError(f"unknown site_mode {self.site_mode!r}")
        if self.site_schedule not in ("sweep", "random"):
            raise ValueError(
                f"unknown site_schedule {self.site_schedule!r}")
        if self.sweep_repeats < 1:
            raise ValueError("sweep_repeats must be >= 1")
        if self.lrep_fallback not in ("litsrep", "match"):
            raise ValueError(
                f"unknown lrep_fallback {self.lrep_fallback!r}")
        if self.accept not in ("cooled", "greedy", "mixed"):
            raise ValueError(f"unknown accept {self.accept!r}")
        if self.init not in ("greedy", "literal", "mixed", "optimal",
                             "mixed_opt"):
            raise ValueError(f"unknown init {self.init!r}")

    def iters(self, n: int) -> int:
        if self.iters_per_epoch:
            return self.iters_per_epoch
        return max(32, min(16 * n // max(self.chains, 1), n))
