"""The control: the reference put in the program's place, its costs
summed in float32 (one step below the exact integer the configuration
states), must come out not correct.  benchmark/control.py makes the same
comparison on the card at the cells' own sizes."""
import pytest

from benchconf import BENCH, S  # noqa: F401
from benchlib import check, reference as R

with open(f"{BENCH}/data/libc.so-128k", "rb") as f:
    LIBC = f.read()
with open(f"{BENCH}/data/survey.md-2k", "rb") as f:
    TEXT = f.read()


def _stream(data, kind):
    import numpy as np
    from megalania_tpu_torch.match import candidates as C_
    from megalania_tpu_torch.match.suffix import build_lce
    from megalania_tpu_torch.models import packets as P
    from megalania_tpu_torch.runtime import emit
    arr = np.frombuffer(data, np.uint8)
    if kind == "literal":
        slab = P.literal_slab(len(arr))
    else:
        slab = C_.greedy_slab(arr, C_.build_candidates(
            arr, 16, 96, build_lce(arr)))
    return emit.emit(data, slab)


@pytest.mark.parametrize("data,kind", [(LIBC[:65536], "literal"),
                                       (TEXT, "greedy")],
                         ids=["libc64k", "text2k"])
def test_control_is_not_correct(data, kind):
    stream = _stream(data, kind)
    exact = R.decode(stream).cost
    assert check.verdict(check.streams([data], [stream], [exact]))
    f32 = R.decode(stream, f32=True).cost
    control = check.streams([data], [stream], [f32])
    assert control["best_cost_gap"] > 0
    assert not check.verdict(control)
