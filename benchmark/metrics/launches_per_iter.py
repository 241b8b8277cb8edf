"""Device operations per iteration over the profiled iterations: the
profiler's device events counted, as tools/profile_torch_iter.py
counts its kernel_launches_per_iter."""
from benchlib import devtrace


def read(obs):
    return devtrace.launches_per_unit(obs.get("profile"), "iterations")
