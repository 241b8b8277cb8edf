"""Plain-Python LZMA packet encoder, cost model, and range coder.

This is the host-side *oracle* implementation of the codec semantics: a
direct, readable realization of the LZMA-alone format (packet layout per
the reference's src/lzma_packet_encoder.c, range coding per
range_encoder.c:18-81, header per lzma_header_encoder.c:5-21 — re-derived,
not translated).  It serves three roles:

  1. golden oracle for the JAX bit-plan compiler (tests),
  2. fallback emitter when the C++ extension is unavailable,
  3. the spec for the C++ op-stream emitter.

It shares the flat probability-table layout of ops/tables.py so JAX and
Python prob states are directly comparable.
"""
from __future__ import annotations

import struct
from typing import List, Tuple

import numpy as np

from ..ops import tables as T
from ..models import packets as P

PROB_ONE = T.PROB_ONE
MOVE_BITS = T.MOVE_BITS


class CostSink:
    """Accumulates exact fractional bit cost in 53.11 fixed point."""

    def __init__(self):
        self.perplexity = 0

    def encode_bit(self, bit: int, prob: int):
        self.perplexity += int(T.LOG2_TABLE_NP[PROB_ONE - prob if bit else prob])

    def encode_direct_bits(self, bits: int, num_bits: int):
        self.perplexity += num_bits << T.PROB_BITS


class RangeSink:
    """Carry-exact LZMA range coder writing real bytes."""

    def __init__(self):
        self.low = 0
        self.range = 0xFFFFFFFF
        self.cache = 0
        self.cache_size = 1
        self.out = bytearray()

    def _shift_low(self):
        if self.low < 0xFF000000 or self.low > 0xFFFFFFFF:
            carry = self.low >> 32
            self.out.append((self.cache + carry) & 0xFF)
            for _ in range(self.cache_size - 1):
                self.out.append((0xFF + carry) & 0xFF)
            self.cache_size = 0
            self.cache = (self.low >> 24) & 0xFF
        self.cache_size += 1
        self.low = (self.low << 8) & 0xFFFFFFFF

    def encode_bit(self, bit: int, prob: int):
        bound = (self.range >> T.PROB_BITS) * prob
        if bit:
            self.low += bound
            self.range -= bound
        else:
            self.range = bound
        while self.range < (1 << 24):
            self.range = (self.range << 8) & 0xFFFFFFFF
            self._shift_low()

    def encode_direct_bits(self, bits: int, num_bits: int):
        for i in range(num_bits - 1, -1, -1):
            self.range >>= 1
            if (bits >> i) & 1:
                self.low += self.range
            if self.range < (1 << 24):
                self.range = (self.range << 8) & 0xFFFFFFFF
                self._shift_low()

    def flush(self) -> bytes:
        for _ in range(5):
            self._shift_low()
        return bytes(self.out)


class Encoder:
    """Adaptive packet encoder over a pluggable sink."""

    def __init__(self, data: bytes, sink, lc: int = 0):
        self.data = data
        self.sink = sink
        self.lc = lc
        self.probs = T.init_probs_np(lc=lc)
        self.ctx = 0
        self.dists = [0, 0, 0, 0]
        self.pos = 0

    # -- adaptive primitives -------------------------------------------
    def _bit(self, bit: int, slot: int):
        p = int(self.probs[slot])
        self.sink.encode_bit(bit, p)
        if bit:
            p -= p >> MOVE_BITS
        else:
            p += (PROB_ONE - p) >> MOVE_BITS
        self.probs[slot] = p

    def _tree(self, value: int, nbits: int, base: int):
        m = 1
        for i in range(nbits - 1, -1, -1):
            bit = (value >> i) & 1
            self._bit(bit, base + m)
            m = (m << 1) | bit

    def _tree_rev(self, value: int, nbits: int, base: int):
        m = 1
        for _ in range(nbits):
            bit = value & 1
            value >>= 1
            self._bit(bit, base + m)
            m = (m << 1) | bit

    # -- packet pieces --------------------------------------------------
    def _header(self, is_match: bool, is_rep: bool = False,
                b3: bool = False, b4: bool = False, b5: bool = False):
        self._bit(int(is_match), T.IS_MATCH + (self.ctx << T.POS_BITS_MAX))
        if not is_match:
            return
        self._bit(int(is_rep), T.IS_REP + self.ctx)
        if not is_rep:
            return
        self._bit(int(b3), T.IS_REP_G0 + self.ctx)
        if b3:
            self._bit(int(b4), T.IS_REP_G1 + self.ctx)
            if b4:
                self._bit(int(b5), T.IS_REP_G2 + self.ctx)
        else:
            self._bit(int(b4), T.IS_REP0_LONG + (self.ctx << T.POS_BITS_MAX))

    def _length(self, base: int, length: int):
        len2 = length - T.MATCH_LEN_MIN
        if len2 < 8:
            self._bit(0, base + T.LEN_CHOICE1)
            self._tree(len2, 3, base + T.LEN_LOW)
        elif len2 < 16:
            self._bit(1, base + T.LEN_CHOICE1)
            self._bit(0, base + T.LEN_CHOICE2)
            self._tree(len2 - 8, 3, base + T.LEN_MID)
        else:
            self._bit(1, base + T.LEN_CHOICE1)
            self._bit(1, base + T.LEN_CHOICE2)
            self._tree(len2 - 16, 8, base + T.LEN_HIGH)

    def _distance(self, dist: int, length: int):
        len_ctx = min(length - T.MATCH_LEN_MIN, 3)
        if dist < 4:
            ps = dist
        else:
            nlb = dist.bit_length() - 2
            high = dist >> nlb
            ps = nlb * 2 + high
        self._tree(ps, 6, T.DIST_SLOT + 64 * len_ctx)
        if ps < 4:
            return
        nlb = (ps >> 1) - 1 if ps < 14 else dist.bit_length() - 2
        low = dist & ((1 << nlb) - 1)
        high = dist >> nlb
        if ps < 14:
            self._tree_rev(low, nlb, T.POS_CODER + (high << nlb) - ps)
        else:
            self.sink.encode_direct_bits(low >> 4, nlb - 4)
            self._tree_rev(dist & 15, 4, T.ALIGN)

    # -- packets --------------------------------------------------------
    def _literal(self):
        self._header(False)
        byte = self.data[self.pos]
        matched = self.ctx >= 7
        match_byte = self.data[self.pos - self.dists[0] - 1] if matched else 0
        # lc literal-context bits of the previous byte select the
        # sub-table (LZMA spec; lc=0 reproduces the reference exactly)
        prev = self.data[self.pos - 1] if self.pos > 0 else 0
        base = T.LIT + ((prev >> (8 - self.lc)) * 0x300 if self.lc else 0)
        symbol = 1
        for i in range(7, -1, -1):
            bit = (byte >> i) & 1
            slot = base + symbol
            if matched:
                mbit = (match_byte >> i) & 1
                slot += (1 + mbit) << 8
                matched = mbit == bit
            self._bit(bit, slot)
            symbol = (symbol << 1) | bit

    def encode_packet(self, ptype: int, dist: int, length: int):
        if ptype == P.LIT:
            self._literal()
        elif ptype == P.MATCH:
            self._header(True, False)
            self.dists = [dist] + self.dists[:3]
            self._length(T.LEN, length)
            self._distance(dist, length)
        elif ptype == P.SREP:
            self._header(True, True, False, False)
        elif ptype == P.LREP:
            self._header(True, True, dist != 0, dist != 1, dist != 2)
            d = self.dists[dist]
            del self.dists[dist]
            self.dists.insert(0, d)
            self._length(T.REP_LEN, length)
        else:
            raise ValueError(f"bad packet type {ptype}")
        self.ctx = int(T.CTX_TRANSITION_NP[ptype, self.ctx])
        self.pos += length


def walk_slab(slab: np.ndarray, dists=None):
    """Yield (position, type, dist, len) for each live packet.

    dists: optional full-width per-position MATCH distances (wide-block
    mode — blocks beyond the packed format's 1 MiB dist cap)."""
    ptype, dist, length, _ = P.unpack_np(slab)
    pos, n = 0, len(slab)
    while pos < n:
        d = int(dist[pos])
        if dists is not None and ptype[pos] == P.MATCH:
            d = int(dists[pos])
        yield pos, int(ptype[pos]), d, int(length[pos])
        pos += int(length[pos])


def parse_cost(data: bytes, slab: np.ndarray, lc: int = 0) -> int:
    """Exact perplexity (bits << 11) of the parse; oracle for the JAX scan."""
    sink = CostSink()
    enc = Encoder(data, sink, lc=lc)
    for _, t, d, l in walk_slab(slab):
        enc.encode_packet(t, d, l)
    return sink.perplexity


def lzma_header(data_size: int, lc=0, lp=0, pb=0, dict_size=0x400000) -> bytes:
    props = (pb * 5 + lp) * 9 + lc
    return struct.pack("<BIQ", props, dict_size, data_size)


def emit(data: bytes, slab: np.ndarray, dict_size=0x400000,
         lc: int = 0, dists=None) -> bytes:
    """Produce a complete .lzma (LZMA-alone) stream for the parse."""
    # the header's dict size must cover every match distance (wide
    # blocks can exceed the 4 MiB default)
    while dict_size < len(data):
        dict_size <<= 1
    sink = RangeSink()
    enc = Encoder(data, sink, lc=lc)
    for _, t, d, l in walk_slab(slab, dists):
        enc.encode_packet(t, d, l)
    return lzma_header(len(data), lc=lc,
                       dict_size=dict_size) + sink.flush()
