"""The table of peaks and the work the kernels must do (frozen).

Peaks are NVIDIA's data sheet for the H100 SXM part (80 GB HBM3): a
roofline share is stated against them, with the card's power limit
beside it in PERF.md.
"""
from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}
DEFAULT_PEAK = "NVIDIA H100 80GB HBM3"


def hbm_bytes_per_s(device_name: str) -> float:
    return PEAKS.get(device_name, PEAKS[DEFAULT_PEAK])["hbm_bytes_per_s"]


def repair_bytes(chains: int, n: int, start: int, packed_rows: int) -> int:
    """The bytes one repair launch must move, a lower bound (after
    chip_smoke.repair_work, cut to what every implementation needs).
    Counted once each, over positions start..n only: the chains' slab
    cells read and written, the block's bytes, the int32 log2 table,
    and the snapshot state read and written (the probabilities, one
    int32 per packed row, and the 16-word coder carry).  The prefix,
    which passes through unchanged, and the data-dependent candidate
    rows are left out, so a share of it can only read low."""
    span = max(0, n - start)
    return (2 * chains * span * 4 + span + 2048 * 4
            + 2 * chains * packed_rows * 4 + 2 * chains * 16 * 4)
