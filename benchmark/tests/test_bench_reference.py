"""The plain reference against an independent encoder (liblzma) and
against the program's own cost oracle and emitter."""
import lzma

import numpy as np
import pytest

from benchconf import BENCH, S  # noqa: F401
from benchlib import reference as R

with open(f"{BENCH}/data/libc.so-128k", "rb") as f:
    LIBC = f.read()
with open(f"{BENCH}/data/survey.md-2k", "rb") as f:
    TEXT = f.read()


@pytest.mark.parametrize("preset", [0, 6, 9 | lzma.PRESET_EXTREME])
@pytest.mark.parametrize("data", [LIBC[:8192], TEXT, b"x", b"a" * 5000],
                         ids=["libc8k", "text2k", "one", "run"])
def test_decodes_liblzma(data, preset):
    """liblzma's own streams (lc=3, lp=0, pb=2 by default): the decoder
    follows the format, not the program's settings."""
    stream = lzma.compress(data, format=lzma.FORMAT_ALONE, preset=preset)
    d = R.decode(stream)
    assert d.data == data and d.cost > 0


def test_log2_table():
    t = R.COST
    assert t[0] == 0 and t[1024] == 2048 and t[2047] == 1
    assert t[1] == int(np.trunc(11 * 2048))


def _program_parse(data, kind, lc):
    from megalania_tpu_torch.anneal.config import AnnealConfig
    from megalania_tpu_torch.match import candidates as C_, optparse
    from megalania_tpu_torch.match.suffix import build_lce
    from megalania_tpu_torch.models import packets as P
    arr = np.frombuffer(data, np.uint8)
    if kind == "optimal":
        return optparse.seed_slab(arr, AnnealConfig(lc=lc))[0]
    if kind == "literal":
        return P.literal_slab(len(arr))
    idx = build_lce(arr)
    return C_.greedy_slab(arr, C_.build_candidates(arr, 16, 96, idx))


@pytest.mark.parametrize("kind", ["optimal", "greedy", "literal"])
@pytest.mark.parametrize("lc", [0, 3])
@pytest.mark.parametrize("src", ["libc", "text"])
def test_cost_equals_the_programs_oracle(kind, lc, src):
    from megalania_tpu_torch.runtime import emit, pyemit
    data = (LIBC[:4096] if src == "libc" else TEXT)
    slab = _program_parse(data, kind, lc)
    want = pyemit.parse_cost(data, slab, lc=lc)
    stream = emit.emit(data, slab, lc=lc)
    d = R.decode(stream)
    assert d.data == data and d.cost == want
    assert d.consumed == len(stream)
    assert R.parse_cost(data, R.parse_packed(slab), lc=lc) == want


def test_a_wrong_parse_is_refused():
    from megalania_tpu_torch.models import packets as P
    data = TEXT[:512]
    slab = _program_parse(data, "greedy", 0)
    pk = R.parse_packed(slab)
    i = next(j for j, p in enumerate(pk) if p.kind == R.MATCH)
    pk[i] = pk[i]._replace(dist=pk[i].dist + 1)
    with pytest.raises(R.StreamError):
        R.parse_cost(data, pk)
    bad = slab.copy()
    bad[0] = P.pack_np(R.LIT, 0, 2)       # a literal of length 2
    with pytest.raises(R.StreamError):
        R.parse_packed(bad)


def test_an_altered_stream_is_caught():
    from megalania_tpu_torch.runtime import emit
    data = LIBC[:4096]
    stream = bytearray(emit.emit(data, _program_parse(data, "greedy", 0)))
    stream[200] ^= 0x10
    try:
        d = R.decode(bytes(stream))
    except R.StreamError:
        return
    assert d.data != data


def test_container():
    a, b = b"\x5d" + bytes(20), b"\x5d" + bytes(30)
    import struct
    blob = (b"MLZ1" + struct.pack("<I", 2) + struct.pack("<QQ", 21, 7) + a
            + struct.pack("<QQ", 31, 9) + b)
    assert R.container_streams(blob) == [a, b]
    assert R.container_streams(a) == [a]
    with pytest.raises(R.StreamError):
        R.container_streams(blob + b"x")


def test_float32_sum_is_not_exact():
    """The control's precision: a float32 sum of a 64 KiB block's costs
    misses the exact integer."""
    from megalania_tpu_torch.runtime import emit
    data = LIBC[:65536]
    from megalania_tpu_torch.models import packets as P
    stream = emit.emit(data, P.literal_slab(len(data)))
    assert R.decode(stream, f32=True).cost != R.decode(stream).cost
