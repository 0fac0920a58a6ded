"""The end-to-end arithmetic against hand counts."""
import pytest

from portbench import stats


def test_cells_per_s_hand_count():
    # three steps of 1000 cells in a window of 2 s
    assert stats.cells_per_s([1000, 1000, 1000], 2.0) == 1500.0
    # AMR: every level's cells count
    assert stats.cells_per_s([1000 + 500], 0.5) == 3000.0


def test_stall_lowers_the_rate():
    steps = [0.1] * 10
    window = sum(steps)
    calm = stats.cells_per_s([100] * 10, window)
    # the same steps with a 0.5 s stall of the host between two of them
    stalled = stats.cells_per_s([100] * 10, window + 0.5)
    assert stalled == pytest.approx(1000.0 / 1.5) and stalled < calm


def test_step_ms_p90_hand_count():
    # 11 steps: 10 ms .. 110 ms; rank 0.9 * 10 = 9 -> the 10th value
    s = [0.01 * k for k in range(1, 12)]
    assert stats.step_ms_p90(s) == pytest.approx(100.0)
    # between ranks: 0.9 * 4 = 3.6 -> 40 + 0.6 * (50 - 40) ms
    assert stats.step_ms_p90([0.05, 0.01, 0.04, 0.02, 0.03]) == \
        pytest.approx(46.0)


def test_step_ms_p90_sees_slow_steps_the_mean_hides():
    even = [0.1] * 20
    uneven = [0.085] * 17 + [0.185] * 3
    assert sum(uneven) == pytest.approx(sum(even))
    assert stats.step_ms_p90(uneven) > stats.step_ms_p90(even)
