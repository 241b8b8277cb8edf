"""Host ms of the program's span emit (runtime.emit.emit, one per block
emitted) in the traced file, the mean: emit_ms_per_block read from
inside the program."""
from benchlib import spans


def read(obs):
    return spans.per_block_ms(obs, spans.BLOCK)
