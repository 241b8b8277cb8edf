"""repair_ms_per_iter in the 1 MiB cell, over its profiled sweep, where
the repair kernel reads the block's bytes from device memory: the same
reader."""
from benchlib import spec

read = spec.metric_reader("repair_ms_per_iter")
