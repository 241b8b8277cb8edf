"""The repair kernel's share of its roofline, in %: the least time its
launches' work needs (roofline.repair_bytes, a lower bound, over the
card's HBM bandwidth) over the kernel's device time in the profiled
iterations."""
from benchlib import devtrace, roofline


def read(obs):
    prof = obs.get("profile")
    launches = obs.get("repair_launches")
    if not prof or not launches:
        return None
    seconds = devtrace.device_seconds(prof["dev"], "repair")
    if seconds <= 0:
        return None
    need = sum(roofline.repair_bytes(C, n, s, pr) for C, n, s, pr in launches)
    bw = roofline.hbm_bytes_per_s(obs.get("device_kind", ""))
    return 100.0 * need / bw / seconds
