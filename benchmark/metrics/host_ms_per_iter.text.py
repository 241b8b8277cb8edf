"""Host ms of an iteration under the profiler: the program's five
iteration spans (iter.draw, iter.cost, iter.accept, iter.best,
iter.restart, which tile engine.anneal_iteration) summed over the
profiled iterations, over their number.  The profiler's own cost per
operation is included."""
from benchlib import spans


def read(obs):
    return spans.per_iter_ms(obs, "iter.")
