"""repair_roofline in the 1 MiB cell, over its profiled sweep: the same
reader and the same bytes (roofline.repair_bytes), on the kernel's
device-memory path."""
from benchlib import spec

read = spec.metric_reader("repair_roofline")
