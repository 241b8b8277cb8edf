"""The repair kernel's work count on hand-worked shapes."""
from benchconf import S  # noqa: F401
from benchlib import roofline


def test_fresh_walk_of_a_block():
    # C=2, n=10, start 0, 3 packed rows: slabs 2*2*10*4 = 160, bytes 10,
    # log2 table 8192, probabilities 2*2*3*4 = 48, carries 2*2*16*4 = 256
    assert roofline.repair_bytes(2, 10, 0, 3) == 160 + 10 + 8192 + 48 + 256


def test_only_the_suffix_counts():
    # from position 6 of 10: slabs 2*2*4*4 = 64, bytes 4
    assert roofline.repair_bytes(2, 10, 6, 3) == 64 + 4 + 8192 + 48 + 256
    # at the end nothing is walked; the table and the state remain
    assert roofline.repair_bytes(2, 10, 10, 3) == 8192 + 48 + 256


def test_main_path_launch():
    # 128 chains re-costing the second half of 64 KiB, 1,152 packed rows
    b = roofline.repair_bytes(128, 65536, 32768, 1152)
    assert b == 2 * 128 * 32768 * 4 + 32768 + 8192 + 2 * 128 * 1152 * 4 \
        + 2 * 128 * 16 * 4
    seconds = b / roofline.hbm_bytes_per_s("NVIDIA H100 80GB HBM3")
    assert 1.0e-5 < seconds < 1.2e-5          # ~0.011 ms


def test_peak_table():
    assert roofline.hbm_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
