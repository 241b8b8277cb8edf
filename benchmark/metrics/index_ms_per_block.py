"""Host ms a block spends in the program's span context.index (the LCE
index and the annealer's candidate table, engine.make_context) in the
traced file, over the blocks emitted there."""
from benchlib import spans


def read(obs):
    return spans.per_block_ms(obs, "context.index")
