"""What the benchmark's tests share: the paths, and tiny cells that the
program's plain versions run on the CPU in seconds."""
import copy
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

from benchlib import spec as S  # noqa: E402


def tiny(workload: str, length: int = 256, chains: int = 8):
    """(spec, workload entry, config, mix) of a cell cut to run on the
    CPU: `length` bytes, `chains` chains, 16-iteration segments."""
    spec = S.load(ROOT)
    wl = dict(S.by_name(spec["workloads"], workload))
    conf = copy.deepcopy(S.config(spec, wl["config"], ROOT))
    conf["anneal"].update(chains=chains, chain_block=8)
    mix = S.traffic(wl["traffic"])
    mix["length"] = length
    if mix["kind"] == "anneal_block":
        mix.update(segment_iters=16, profile_iters=2, check_chains=2)
    else:
        conf["anneal"]["block_size"] = length // 2
        mix.update(total_moves=chains * 2 * 2, warmup_bytes=64,
                   warmup_moves=chains)
    return spec, wl, conf, mix
