"""The plain reference that decides `correct`: LZMA-alone decoding and the
exact cost of a parse, written from the LZMA format itself.

Independent of the program under test: it imports nothing of it and
takes nothing it made, apart from the outputs it judges (an emitted
stream or container, a parse in the packed word format).  Pure Python
and NumPy on the host.

The cost of a parse is the Megalania cost model (perplexity_encoder.c):
every binary decision coded with an adaptive 11-bit probability p of a
0 costs trunc(-log2(q / 2048) * 2048), q = p for a 0 and 2048 - p for a
1 (index 0 costs 0); every direct bit costs 2048.  The sum is an exact
integer in units of 1/2048 bit.  Decoding a stream and summing its
decisions' costs gives the cost of the parse the stream holds; walking
a parse through the same model gives the cost the encoder would pay.

`Coder` objects drive one walk: a `Decoder` takes each decision from
the range decoder, a `Script` from the parse being costed.  The
`f32` option accumulates the per-decision costs in float32, the step
below the model's exact integer sum (the control of PERF.md).
"""
from __future__ import annotations

import struct
from typing import List, NamedTuple, Optional

import numpy as np

ONE = 2048                    # 11-bit probabilities
MOVE = 5                      # adaptation shift
TOP = 1 << 24
M32 = 0xFFFFFFFF
LIT, MATCH, SREP, LREP = 0, 1, 2, 3     # packet kinds of the packed format


def log2_cost_table() -> List[int]:
    """trunc(-log2(i / 2048) * 2048) for i in 1..2047; 0 at index 0."""
    i = np.arange(1, ONE, dtype=np.float64)
    return [0] + [int(v) for v in np.trunc(-np.log2(i / ONE) * ONE)]


COST = log2_cost_table()


class StreamError(ValueError):
    """A stream or parse that breaks the format or the data."""


class Packet(NamedTuple):
    kind: int        # LIT, MATCH, SREP, LREP
    dist: int        # MATCH: distance - 1; LREP: rep index 0..3
    length: int


class _Acc:
    """The cost sum: an exact Python int, or a float32 accumulator."""

    def __init__(self, f32: bool):
        self.f32 = f32
        self.exact = 0
        self.terms: List[int] = []

    def add(self, c: int):
        if self.f32:
            self.terms.append(c)
        else:
            self.exact += c

    def total(self) -> int:
        if not self.f32:
            return self.exact
        if not self.terms:
            return 0
        # a sequential float32 sum, term by term (cumsum does not pair)
        return int(np.cumsum(np.asarray(self.terms, np.float32),
                             dtype=np.float32)[-1])


class Decoder:
    """The LZMA range decoder: each decision comes from the stream."""

    def __init__(self, buf: bytes, pos: int, f32: bool = False):
        if len(buf) < pos + 5 or buf[pos] != 0:
            raise StreamError("bad range coder start")
        self.buf, self.pos = buf, pos + 5
        self.range = M32
        self.code = int.from_bytes(buf[pos + 1:pos + 5], "big")
        self.acc = _Acc(f32)

    def _byte(self) -> int:
        if self.pos >= len(self.buf):
            raise StreamError("stream ends early")
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def bit(self, probs: list, i: int, want: Optional[int]) -> int:
        p = probs[i]
        bound = (self.range >> 11) * p
        if self.code < bound:
            self.range = bound
            probs[i] = p + ((ONE - p) >> MOVE)
            self.acc.add(COST[p])
            b = 0
        else:
            self.code -= bound
            self.range -= bound
            probs[i] = p - (p >> MOVE)
            self.acc.add(COST[ONE - p])
            b = 1
        if self.range < TOP:
            self.range = (self.range << 8) & M32
            self.code = ((self.code << 8) | self._byte()) & M32
        return b

    def direct(self, nbits: int, want: Optional[int]) -> int:
        v = 0
        for _ in range(nbits):
            self.range >>= 1
            b = 0
            if self.code >= self.range:
                self.code -= self.range
                b = 1
            v = (v << 1) | b
            if self.range < TOP:
                self.range = (self.range << 8) & M32
                self.code = ((self.code << 8) | self._byte()) & M32
        self.acc.add(nbits * ONE)
        return v


class Script:
    """Each decision is the one the parse being costed makes."""

    def __init__(self, f32: bool = False):
        self.acc = _Acc(f32)

    def bit(self, probs: list, i: int, want: Optional[int]) -> int:
        p = probs[i]
        if want:
            probs[i] = p - (p >> MOVE)
            self.acc.add(COST[ONE - p])
            return 1
        probs[i] = p + ((ONE - p) >> MOVE)
        self.acc.add(COST[p])
        return 0

    def direct(self, nbits: int, want: Optional[int]) -> int:
        self.acc.add(nbits * ONE)
        return want


def _tree(c, probs, base, nbits, value=None) -> int:
    m = 1
    for i in range(nbits - 1, -1, -1):
        b = c.bit(probs, base + m, None if value is None
                  else (value >> i) & 1)
        m = (m << 1) | b
    return m - (1 << nbits)


def _tree_rev(c, probs, base, nbits, value=None) -> int:
    m, v = 1, 0
    for i in range(nbits):
        b = c.bit(probs, base + m, None if value is None
                  else (value >> i) & 1)
        m = (m << 1) | b
        v |= b << i
    return v


class _Len:
    def __init__(self, pb: int):
        self.choice = [1024, 1024]
        self.low = [[1024] * 8 for _ in range(1 << pb)]
        self.mid = [[1024] * 8 for _ in range(1 << pb)]
        self.high = [1024] * 256

    def code(self, c, ps: int, length: Optional[int]) -> int:
        """Match length (2..273) through the length coder."""
        v = None if length is None else length - 2
        if c.bit(self.choice, 0, None if v is None else int(v >= 8)) == 0:
            return 2 + _tree(c, self.low[ps], 0, 3, v)
        if c.bit(self.choice, 1, None if v is None else int(v >= 16)) == 0:
            return 10 + _tree(c, self.mid[ps], 0, 3,
                              None if v is None else v - 8)
        return 18 + _tree(c, self.high, 0, 8, None if v is None else v - 16)


class Model:
    """The LZMA probability model and coder state (lc, lp, pb general)."""

    def __init__(self, lc: int = 0, lp: int = 0, pb: int = 0):
        self.lc, self.lp, self.pb = lc, lp, pb
        self.is_match = [1024] * (12 << pb)
        self.is_rep = [1024] * 12
        self.is_rep_g0 = [1024] * 12
        self.is_rep_g1 = [1024] * 12
        self.is_rep_g2 = [1024] * 12
        self.is_rep0_long = [1024] * (12 << pb)
        self.lit = [1024] * (0x300 << (lc + lp))
        self.len = _Len(pb)
        self.rep_len = _Len(pb)
        self.slot = [[1024] * 64 for _ in range(4)]
        self.special = [1024] * 115
        self.align = [1024] * 16
        self.state = 0
        self.reps = [0, 0, 0, 0]

    def _distance(self, c, length: int, dist: Optional[int]) -> int:
        probs = self.slot[min(length - 2, 3)]
        if dist is None:
            ps = None
        elif dist < 4:
            ps = dist
        else:
            nb = dist.bit_length() - 2
            ps = 2 * nb + (dist >> nb)
        ps = _tree(c, probs, 0, 6, ps)
        if ps < 4:
            return ps
        nb = (ps >> 1) - 1
        base = (2 | (ps & 1)) << nb
        low = None if dist is None else dist - base
        if ps < 14:
            return base + _tree_rev(c, self.special, base - ps, nb, low)
        hi = c.direct(nb - 4, None if low is None else low >> 4)
        return base + (hi << 4) + _tree_rev(
            c, self.align, 0, 4, None if low is None else low & 15)

    def packet(self, c, out: bytearray, want: Optional[Packet],
               data: Optional[bytes] = None) -> Packet:
        """Code one packet at position len(out).  Decoding (want None)
        appends its bytes to `out`, or returns None at an end marker;
        costing (want given) checks them against `data` and appends
        them."""
        pos = len(out)
        ps = pos & ((1 << self.pb) - 1)
        st = self.state
        w = want
        if c.bit(self.is_match, (st << self.pb) + ps,
                 None if w is None else int(w.kind != LIT)) == 0:
            prev = out[-1] if pos else 0
            ls = ((pos & ((1 << self.lp) - 1)) << self.lc) + (
                prev >> (8 - self.lc))
            base = 0x300 * ls
            target = None if w is None else data[pos]
            sym, i = 1, 7
            if st >= 7:
                if self.reps[0] >= pos:
                    raise StreamError(f"matched literal at {pos} before "
                                      "its rep0")
                mb = out[pos - self.reps[0] - 1]
                while i >= 0:
                    mbit = (mb >> i) & 1
                    b = c.bit(self.lit, base + ((1 + mbit) << 8) + sym,
                              None if target is None
                              else (target >> i) & 1)
                    sym = (sym << 1) | b
                    i -= 1
                    if b != mbit:
                        break
            while i >= 0:
                sym = (sym << 1) | c.bit(
                    self.lit, base + sym,
                    None if target is None else (target >> i) & 1)
                i -= 1
            out.append(sym & 0xFF)
            self.state = 0 if st < 4 else (st - 3 if st < 10 else st - 6)
            return Packet(LIT, 0, 1)
        if c.bit(self.is_rep, st,
                 None if w is None else int(w.kind in (SREP, LREP))) == 0:
            length = self.len.code(c, ps, None if w is None else w.length)
            dist = self._distance(c, length, None if w is None else w.dist)
            if w is None and dist == M32:
                return None                       # the end marker
            self.reps = [dist] + self.reps[:3]
            self.state = 7 if st < 7 else 10
            self._copy(out, dist, length)
            return Packet(MATCH, dist, length)
        if pos == 0:
            raise StreamError("rep at position 0")
        k = None if w is None else (0 if w.kind == SREP else w.dist)
        if c.bit(self.is_rep_g0, st, None if k is None else int(k != 0)) == 0:
            if c.bit(self.is_rep0_long, (st << self.pb) + ps,
                     None if w is None else int(w.kind == LREP)) == 0:
                self.state = 9 if st < 7 else 11
                self._copy(out, self.reps[0], 1)
                return Packet(SREP, 0, 1)
            k = 0
        elif c.bit(self.is_rep_g1, st, None if k is None
                   else int(k != 1)) == 0:
            k = 1
        else:
            k = 2 + c.bit(self.is_rep_g2, st, None if k is None
                          else int(k != 2))
        d = self.reps.pop(k)
        self.reps.insert(0, d)
        length = self.rep_len.code(c, ps, None if w is None else w.length)
        self.state = 8 if st < 7 else 11
        self._copy(out, d, length)
        return Packet(LREP, k, length)

    @staticmethod
    def _copy(out: bytearray, dist: int, length: int):
        src = len(out) - dist - 1
        if src < 0:
            raise StreamError(f"distance {dist + 1} beyond position "
                              f"{len(out)}")
        for j in range(length):
            out.append(out[src + j])


class Decoded(NamedTuple):
    data: bytes
    cost: int             # exact (or float32-summed) cost of the parse
    packets: int
    consumed: int         # stream bytes the decoder read


def decode(stream: bytes, f32: bool = False) -> Decoded:
    """Decode one LZMA-alone stream (13-byte header; a known size, or
    the unknown size and an end marker)."""
    if len(stream) < 18:
        raise StreamError("stream shorter than a header and a flush")
    props, _dict, size = struct.unpack_from("<BIQ", stream, 0)
    if props >= 9 * 5 * 5:
        raise StreamError("bad properties byte")
    lc, rest = props % 9, props // 9
    lp, pb = rest % 5, rest // 5
    unknown = size == (1 << 64) - 1          # ends with an end marker
    model = Model(lc, lp, pb)
    c = Decoder(stream, 13, f32)
    out = bytearray()
    n = 0
    while unknown or len(out) < size:
        if model.packet(c, out, None) is None:
            if not unknown:
                raise StreamError("end marker inside a sized stream")
            break
        n += 1
    if not unknown and len(out) != size:
        raise StreamError(f"{len(out)} bytes decoded, header says {size}")
    return Decoded(bytes(out), c.acc.total(), n, c.pos)


def parse_packed(words: np.ndarray) -> List[Packet]:
    """The packets of a parse in the packed word format (one uint32 per
    position: dist bits 0-19, length 20-28, kind 29-30, bit 31 a mark),
    read from position 0 by length."""
    w = np.asarray(words).astype(np.int64) & M32
    kind = ((w >> 29) & 3).tolist()
    dist = (w & 0xFFFFF).tolist()
    length = ((w >> 20) & 0x1FF).tolist()
    out, pos, n = [], 0, len(kind)
    while pos < n:
        k, ln = kind[pos], length[pos]
        if k in (LIT, SREP) and ln != 1:
            raise StreamError(f"kind {k} with length {ln} at {pos}")
        if k in (MATCH, LREP) and not 2 <= ln <= 273:
            raise StreamError(f"length {ln} at {pos}")
        if k == LREP and dist[pos] > 3:
            raise StreamError(f"rep index {dist[pos]} at {pos}")
        out.append(Packet(k, dist[pos], ln))
        pos += ln
    if pos != n:
        raise StreamError(f"parse runs {pos - n} bytes past the block")
    return out


def parse_cost(data: bytes, packets: List[Packet], lc: int = 0,
               f32: bool = False) -> int:
    """The cost of coding `packets` over `data`; raises unless the parse
    reproduces `data` exactly."""
    model = Model(lc)
    c = Script(f32)
    out = bytearray()
    for p in packets:
        start = len(out)
        model.packet(c, out, p, data)
        if out[start:] != data[start:len(out)]:
            raise StreamError(f"packet at {start} does not reproduce the "
                              "data")
    if len(out) != len(data):
        raise StreamError("parse does not cover the block")
    return c.acc.total()


def container_streams(blob: bytes) -> List[bytes]:
    """The block streams of a multi-block container
    (b"MLZ1" | u32 n | per block: u64 stream length | u64 raw length |
    stream), or [blob] for a single LZMA-alone stream."""
    if blob[:4] != b"MLZ1":
        return [blob]
    (n,) = struct.unpack_from("<I", blob, 4)
    off, out = 8, []
    for _ in range(n):
        if off + 16 > len(blob):
            raise StreamError("container ends early")
        clen, _raw = struct.unpack_from("<QQ", blob, off)
        off += 16
        out.append(blob[off:off + clen])
        off += clen
    if off != len(blob):
        raise StreamError("container has trailing bytes")
    return out
