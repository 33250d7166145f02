"""The metric arithmetic on synthetic delivery logs."""

import math

import pytest

from tiny import REPO  # noqa: F401  (puts perfbench on the path)

from harness import stats


def test_rate_counts_whole_deliveries_only():
    # one delivery of 100 every 2 s; the window [1, 8.5] holds those at
    # 2, 4, 6, 8: the first opens it, the other three count over 6 s
    deliveries = [(float(t), 100.0) for t in range(0, 12, 2)]
    assert stats.delivery_window(deliveries, 1.0, 8.5) == (300.0, 6.0)
    assert stats.whole_delivery_rate(deliveries, 1.0, 8.5) == pytest.approx(50.0)


def test_rate_needs_two_deliveries():
    assert stats.whole_delivery_rate([(1.0, 5.0)], 0.0, 2.0) is None
    assert stats.whole_delivery_rate([], 0.0, 2.0) is None


def test_rate_ignores_deliveries_outside_the_window():
    d = [(0.5, 1e9), (1.0, 10.0), (2.0, 10.0), (3.0, 10.0), (3.5, 1e9)]
    assert stats.whole_delivery_rate(d, 1.0, 3.0) == pytest.approx(10.0)


@pytest.mark.parametrize("q,want", [(0, 1.0), (50, 3.0), (100, 5.0), (25, 2.0),
                                    (95, 4.8)])
def test_percentile_is_linear_between_ranks(q, want):
    assert stats.percentile([5.0, 1.0, 3.0, 2.0, 4.0], q) == pytest.approx(want)


def test_missing_requests_count_as_infinite():
    xs = [1.0, 2.0, 3.0, math.inf]
    assert stats.percentile(xs, 50) == pytest.approx(2.5)
    assert math.isinf(stats.percentile(xs, 95))
    assert math.isinf(stats.percentile(xs + [math.inf] * 10, 50))


def test_spread_is_the_quartile_distance_over_the_median():
    xs = [10.0, 10.0, 11.0, 9.0, 10.0, 12.0]
    import statistics
    q1, _, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / statistics.median(xs))
