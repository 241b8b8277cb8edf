"""Block splitting and the multi-block container.

Sequence scaling happens by sharding the *corpus*, not the stream
(SURVEY.md §5.7): the LZMA format is inherently sequential, so each
block is an independent LZMA-alone stream annealed in parallel; outputs
are gathered in order into a simple container.  A single block degrades
to a plain `.lzma` file that xz can decode directly.

Container layout (".mlz"):
    magic b"MLZ1" | u32 n_blocks
    per block: u64 compressed_len | u64 raw_len | <.lzma stream bytes>
"""
from __future__ import annotations

import lzma
import struct
from typing import List

MAGIC = b"MLZ1"


def split_blocks(data: bytes, block_size: int) -> List[bytes]:
    if not data:
        return [b""]
    return [data[i:i + block_size] for i in range(0, len(data), block_size)]


def pack_container(streams: List[bytes], raw_lens: List[int]) -> bytes:
    out = bytearray(MAGIC)
    out += struct.pack("<I", len(streams))
    for s, r in zip(streams, raw_lens):
        out += struct.pack("<QQ", len(s), r)
        out += s
    return bytes(out)


def unpack_container(blob: bytes) -> List[bytes]:
    """-> list of per-block .lzma streams."""
    if blob[:4] != MAGIC:
        raise ValueError("not an MLZ1 container")
    (n,) = struct.unpack_from("<I", blob, 4)
    off = 8
    streams = []
    for _ in range(n):
        clen, _rlen = struct.unpack_from("<QQ", blob, off)
        off += 16
        streams.append(blob[off:off + clen])
        off += clen
    return streams


def decompress(blob: bytes) -> bytes:
    """Decode either a raw .lzma stream or an MLZ1 container."""
    if blob[:4] == MAGIC:
        return b"".join(
            lzma.decompress(s, format=lzma.FORMAT_ALONE)
            for s in unpack_container(blob)
        )
    return lzma.decompress(blob, format=lzma.FORMAT_ALONE)
