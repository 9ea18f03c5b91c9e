"""The benchmark's arithmetic on hand-made inputs."""

import statistics

import pytest

from perfbench.harness import stats
from perfbench.harness.roofline import bound_seconds, delivery_combine_bytes


def test_rate_is_work_over_the_whole_window():
    assert stats.rate(100_000 * 120, 30.0) == 400_000.0
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_p90_is_over_all_requests():
    vals = list(range(1, 101))  # 1..100 ms
    assert stats.p90(vals) == pytest.approx(90.9)
    assert stats.p90(vals) == statistics.quantiles(vals, n=10)[8]
    # one slow request in ten sets the tail
    assert stats.p90([250.0] * 85 + [900.0] * 15) == pytest.approx(900.0)
    with pytest.raises(ValueError):
        stats.p90([1.0])


def test_union_gaps_and_idle_share():
    busy = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0), (5.5, 5.7), (8.0, 10.0)]
    assert stats.union_length(busy) == 6.0
    assert stats.gaps(busy, 0.0, 10.0) == [(3.0, 5.0), (6.0, 8.0)]
    assert stats.gaps(busy, -1.0, 12.0) == [(-1.0, 0.0), (3.0, 5.0), (6.0, 8.0), (10.0, 12.0)]
    assert stats.idle_share(stats.union_length(busy), 10.0) == pytest.approx(0.4)
    assert stats.idle_share(10.0, 10.0) == 0.0


def test_bound_time_and_bytes():
    assert bound_seconds(3.35e12) == pytest.approx(1.0)
    # F = 3, N = 8, Wm = 2, Wu = 1, R = 4, 5 distinct senders
    need = 4 * 3 * 8 + 4 * 4 + 4 * (2 + 1 + 4) * 5 + 8 * (4 + 16 + 8) + 4
    assert delivery_combine_bytes(2, 1, 4, 3, 8, 5) == need
