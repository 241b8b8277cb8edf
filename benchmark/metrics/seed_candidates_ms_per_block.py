"""Host ms a block spends in the program's span seed.candidates (the
optimum-parse seed's own, wider candidate table, optparse.seed_slab) in
the traced file, over the blocks emitted there."""
from benchlib import spans


def read(obs):
    return spans.per_block_ms(obs, "seed.candidates")
