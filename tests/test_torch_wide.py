"""Wide-distance blocks (> 1 MiB) in megalania_tpu_torch: the host-side
DP-only pipeline (native optimum parse with full-width distances, Python
emitter) gives megalania_tpu's bytes, and annealing such a block is a
clear error."""
import lzma

import numpy as np
import pytest

from megalania_tpu import compressor as JCM
from megalania_tpu.anneal.config import AnnealConfig as JConfig
from megalania_tpu_torch import compressor as TCM
from megalania_tpu_torch.anneal.config import AnnealConfig as TConfig

KW = dict(block_size=2 << 20, init="optimal", opt_candidates=8,
          opt_walk=16, opt_passes=2)


def test_wide_block_bytes_equal_reference():
    """tests/test_wide.py's input: a repeat at distance > 1 MiB."""
    rng = np.random.default_rng(7)
    head = bytes(rng.integers(0, 256, (1 << 20) + 10_000, dtype=np.uint8))
    data = head + head[:50_000]
    got = TCM.compress(data, TConfig(**KW), total_moves=0, device="cpu")
    want = JCM.compress(data, JConfig(**KW), total_moves=0, use_mesh=False)
    assert got == want
    assert lzma.decompress(got, format=lzma.FORMAT_ALONE) == data
    assert len(got) < len(data) - 30_000     # the repeat was matched


def test_wide_block_requires_dp_only():
    data = b"x" * ((1 << 20) + 1)
    with pytest.raises(ValueError, match="wide DP-only"):
        TCM.compress_block(data, TConfig(block_size=2 << 20),
                           total_moves=1000, device="cpu")
