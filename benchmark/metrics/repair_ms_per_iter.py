"""Device ms of the repair kernel per iteration over the profiled
iterations (profiler device time of kernels named repair)."""
from benchlib import devtrace


def read(obs):
    prof = obs.get("profile")
    if not prof or prof["scope"] != "iterations" or not prof["iters"]:
        return None
    if not devtrace.count(prof["dev"], "repair"):
        return None
    return devtrace.device_seconds(prof["dev"], "repair") * 1e3 \
        / prof["iters"]
