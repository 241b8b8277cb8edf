"""device_idle_share.anneal in the 1 MiB cell, over its profiled sweep
against an iteration of the unprofiled window: the same reader."""
from benchlib import spec

read = spec.metric_reader("device_idle_share.anneal")
