"""launches_per_iter in the four-card cell, where it moves
moves_per_s.4gpu: the same reader, over rank 0's profiled iterations."""
from benchlib import spec

read = spec.metric_reader("launches_per_iter")
