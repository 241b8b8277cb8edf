"""Reduction of a traced stretch to numbers (frozen).

Input is plain data taken from torch.profiler's events: device
operations as (name, start_us, end_us) and host operations as
(name, start_us, end_us) of the thread that drives the device, on the
profiler's one timeline.  The busy share is the arithmetic of
tools/profile_torch_iter.py: the device operations' summed durations
per unit of work (an iteration, a file) over the wall time of that unit
measured without the profiler, whose own cost on the host would
otherwise read as idle time.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import List, Tuple

Span = Tuple[str, float, float]


def device_seconds(dev: List[Span], match: str = "") -> float:
    """Summed durations of the device operations whose name holds
    `match` (all of them for "")."""
    return sum(e - s for name, s, e in dev if match in name) / 1e6


def busy_share(dev: List[Span], units: int, unit_wall_s: float) -> float:
    """Device seconds per unit over the unprofiled wall seconds per unit."""
    return device_seconds(dev) / units / unit_wall_s


def count(dev: List[Span], match: str = "") -> int:
    return sum(1 for name, _, _ in dev if match in name)


def launches_per_unit(prof, scope: str):
    """Device operations per unit of a profiled stretch of `scope`
    ("iterations", "file"); None without one."""
    if not prof or prof["scope"] != scope or not prof["dev"]:
        return None
    return count(prof["dev"]) / prof["iters"]


def idle_percent(prof, scope: str, unit_wall_s):
    """100 x (1 - busy_share) of a profiled stretch of `scope`; None
    without one."""
    if not prof or prof["scope"] != scope or not prof["dev"] \
            or not unit_wall_s:
        return None
    return 100.0 * (1.0 - busy_share(prof["dev"], prof["iters"],
                                     unit_wall_s))


def busy_union_seconds(dev: List[Span]) -> float:
    """Seconds in which at least one device operation ran."""
    total, end = 0.0, None
    for _, s, e in sorted(dev, key=lambda x: x[1]):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e6


def top_ops(dev: List[Span], k: int = 10) -> list:
    """[name, seconds] of the k device operations that took most time,
    summed by name."""
    acc = defaultdict(float)
    for name, s, e in dev:
        acc[name] += (e - s) / 1e6
    return [[n, v] for n, v in sorted(acc.items(), key=lambda x: -x[1])[:k]]


def _outermost(host: List[Span]) -> List[Span]:
    """Host operations not inside another one (the thread's spans nest)."""
    out, end = [], None
    for sp in sorted(host, key=lambda x: (x[1], -x[2])):
        if end is None or sp[1] >= end:
            out.append(sp)
            end = sp[2]
    return out


def idle_gaps(dev: List[Span], host: List[Span], t0: float, t1: float,
              k: int = 10) -> list:
    """[name, seconds] of the device's idle time inside [t0, t1] (us),
    summed by what the host was doing: the outermost host operation at
    each gap's middle ("host: between operations" where none)."""
    gaps, cur = [], t0
    for _, s, e in sorted(dev, key=lambda x: x[1]):
        if s > cur:
            gaps.append((cur, min(s, t1)))
        cur = max(cur, e)
        if cur >= t1:
            break
    if cur < t1:
        gaps.append((cur, t1))
    tops = _outermost(host)
    starts = [sp[1] for sp in tops]
    acc = defaultdict(float)
    for a, b in gaps:
        if b <= a:
            continue
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        name = ("host: between operations" if i < 0 or tops[i][2] < mid
                else tops[i][0])
        acc[name] += (b - a) / 1e6
    return [[n, v] for n, v in sorted(acc.items(), key=lambda x: -x[1])[:k]]
