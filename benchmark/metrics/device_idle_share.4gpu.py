"""The share of rank 0's card not spent computing over the profiled
iterations, in %: 1 minus the device time of the operations other than
the collectives per profiled iteration over the wall time of an
iteration in the unprofiled window.  The collectives' kernels (names
holding `nccl`, nccl_ms_per_iter) count as waiting: they run from their
launch until the slowest rank joins, and under the profiler the ranks'
hosts fall out of step, so their time there says little of the
unprofiled window."""
from benchlib import devtrace


def read(obs):
    prof = obs.get("profile")
    wall = obs.get("unit_wall_s")
    if not prof or prof["scope"] != "iterations" or not prof["dev"] \
            or not wall:
        return None
    compute = devtrace.device_seconds(prof["dev"]) \
        - devtrace.device_seconds(prof["dev"], "nccl")
    return 100.0 * (1.0 - compute / prof["iters"] / wall)
