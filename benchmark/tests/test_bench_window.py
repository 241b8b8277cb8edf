"""The window's arithmetic on a fake clock."""
import pytest

from benchconf import S  # noqa: F401  (puts the benchmark on sys.path)
from benchlib import window


class Clock:
    def __init__(self, step):
        self.t, self.step = 0.0, step

    def __call__(self):
        return self.t

    def tick(self):
        self.t += self.step


def test_window_ends_with_the_unit_in_which_the_time_passes():
    clock = Clock(0.3)
    units, elapsed = window.run_window(lambda: clock.tick(), 1.0, clock)
    assert len(units) == 4 and elapsed == pytest.approx(1.2)


def test_one_unit_longer_than_the_window():
    clock = Clock(5.0)
    units, elapsed = window.run_window(lambda: clock.tick(), 1.0, clock)
    assert len(units) == 1 and elapsed == 5.0


def test_moves_and_rate():
    # 128 chains x 1 proposal x 2,304 iterations over 10.0 s
    assert window.moves(128, 1, 2304) == 294_912
    assert window.rate(window.moves(128, 1, 2304), 10.0) == 29_491.2
    # 2 files of 131,072 B over 24 s
    assert window.rate(2 * 131072 / 1024, 24.0) == pytest.approx(10.6666667)
    with pytest.raises(ValueError):
        window.rate(1, 0)
