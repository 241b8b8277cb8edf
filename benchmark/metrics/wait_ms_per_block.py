"""Host ms a block spends in the program's span block.wait (where
compressor.compress_block waits on the device: each segment's best cost
and the final readback of the best parse) in the traced file, over the
blocks emitted there: the host time a block does not use."""
from benchlib import spans


def read(obs):
    return spans.per_block_ms(obs, "block.wait")
