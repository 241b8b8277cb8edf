"""The card's idle share over one whole file of the traced run, in %: 1
minus the device operations' summed time over the wall time of a file
in the unprofiled window."""
from benchlib import devtrace


def read(obs):
    return devtrace.idle_percent(obs.get("profile"), "file",
                                 obs.get("unit_wall_s"))
