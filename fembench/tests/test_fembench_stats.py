"""The arithmetic of the metrics on synthetic records: percentiles,
spreads, the window rate, the busy union and the idle gaps."""

import statistics

import pytest

from fembench.harness import stats, trace


def test_percentile():
    v = list(range(1, 101))  # 1..100
    assert stats.percentile(v, 50) == 50.5
    assert stats.percentile(v, 95) == pytest.approx(95.05)
    assert stats.percentile([3.0], 95) == 3.0
    assert stats.percentile([1.0, 2.0], 95) == pytest.approx(1.95)
    with pytest.raises(ValueError):
        stats.percentile(v, 100)


def test_spread_is_iqr_over_median():
    v = [10.0, 10.2, 9.8, 10.1, 9.9, 10.0]
    q1, q2, q3 = statistics.quantiles(v, n=4)
    assert stats.spread(v) == (q3 - q1) / q2
    assert stats.spread([1.0, 1.0, 1.0, 1.0]) == 0.0


def test_window_rate():
    assert stats.window_rate(45.0, 6) == 7.5
    with pytest.raises(ValueError):
        stats.window_rate(1.0, 0)


def test_union_is_not_a_sum():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.2, 3.5), (10.0, 10.0)]
    assert stats.merge(iv) == [(0.0, 2.0), (3.0, 4.0), (10.0, 10.0)]
    assert stats.union_seconds(iv) == 3.0
    assert sum(e - s for s, e in iv) == pytest.approx(3.8)


def test_inside_counts_busy_time_within_ranges():
    merged = [(1.0, 2.0), (3.0, 4.0), (6.0, 9.0)]
    assert stats.inside(merged, [(0.0, 5.0)]) == 2.0
    assert stats.inside(merged, [(1.5, 3.5), (7.0, 8.0)]) == 2.0
    assert stats.inside(merged, [(4.0, 6.0)]) == 0.0
    assert stats.inside([], [(0.0, 1.0)]) == 0.0


def test_gaps():
    merged = [(1.0, 2.0), (3.0, 4.0)]
    assert stats.gaps(merged, 0.0, 5.0) == [(0.0, 1.0), (2.0, 3.0), (4.0, 5.0)]
    assert stats.gaps(merged, 1.5, 3.5) == [(2.0, 3.0)]
    assert stats.gaps([], 0.0, 1.0) == [(0.0, 1.0)]


class _E:
    """A kineto event as the profiler gives it."""

    def __init__(self, name, dev, s, t, tid=1):
        self._n, self._d, self._s, self._t, self._tid = name, dev, s, t, tid

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return int(self._s * 1e9)

    def duration_ns(self):
        return int((self._t - self._s) * 1e9)

    def start_thread_id(self):
        return self._tid


def test_trace_reduction():
    C, G = "cpu", "gpu"
    ev = [
        _E(trace.WINDOW, C, 0.0, 10.0),
        _E("solve", C, 0.0, 9.0),
        _E("cudaLaunchKernel", C, 0.5, 1.0),
        _E("cudaStreamSynchronize", C, 4.0, 6.0),
        _E("void (anonymous namespace)::ell_spmv_kernel<double>(double const*)",
           G, 1.0, 3.0),
        _E("ell_spmv_kernel", G, 2.0, 4.0),
        _E("other_kernel", G, 6.5, 7.0),
        _E("late_kernel", G, 9.5, 11.0),  # clipped to the window
        _E("aten::add", C, 7.2, 7.8, tid=2),  # another thread
    ]
    t = trace.reduce(ev, 10.0, 2, G)
    assert t.busy_s == pytest.approx(3.0 + 0.5 + 0.5)
    assert t.kernel("ell_spmv_kernel") == (pytest.approx(4.0), 2)
    assert t.kernel("other") is None
    # idle: [0,1) in a launch, [4,6.5) mostly in the sync (its midpoint
    # is), [7,9.5) under "solve" alone
    assert t.idle_by_host == {
        "cudaLaunchKernel": pytest.approx(1.0),
        "cudaStreamSynchronize": pytest.approx(2.5),
        "solve": pytest.approx(2.5),
    }
    b = t.breakdown()
    assert b["device_ops"][0][1] == pytest.approx(2.0)
    assert len(b["device_ops"]) == 4 and len(b["idle_gaps"]) == 3
    assert t.sections == {}


def test_trace_reduction_of_sections():
    """Device time inside each annotated Timer section, from the host's
    ranges; the annotations' images on the device's timeline are skipped."""
    C, G = "cpu", "gpu"
    s = trace.SECTION
    ev = [
        _E(trace.WINDOW, C, 0.0, 10.0),
        _E(trace.WINDOW, G, 0.2, 9.9),
        _E(s + "newton_eval", C, 1.0, 3.0),
        _E(s + "newton_eval", G, 1.1, 2.9),
        _E(s + "newton_eval", C, 5.0, 8.0),
        _E(s + "linear_solve", C, 3.0, 5.0),
        _E("tangent", G, 1.0, 2.5),
        _E("tangent", G, 2.0, 2.8),  # overlaps the first
        _E("spmv", G, 3.5, 4.0),
        _E("tangent", G, 6.0, 7.0),
    ]
    t = trace.reduce(ev, 10.0, 1, G)
    assert t.sections == {"newton_eval": (2, pytest.approx(2.8)),
                          "linear_solve": (1, pytest.approx(0.5))}
    assert t.busy_s == pytest.approx(1.8 + 0.5 + 1.0)
    assert t.kernel("tangent") == (pytest.approx(3.3), 3)
