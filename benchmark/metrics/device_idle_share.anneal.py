"""The card's idle share over the profiled iterations, in %: 1 minus the
device operations' summed time per profiled iteration over the wall
time of an iteration in the unprofiled window (the arithmetic of
tools/profile_torch_iter.py)."""
from benchlib import devtrace


def read(obs):
    return devtrace.idle_percent(obs.get("profile"), "iterations",
                                 obs.get("unit_wall_s"))
