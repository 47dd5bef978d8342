"""The trace reduction of tools/trace_pool.py on synthetic device events."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
import trace_pool  # noqa: E402


def test_busy_time_is_the_union_of_stream_intervals():
    events = [("Stream #13(Compute)", "a", 0, 100),
              ("Stream #13(Compute)", "b", 50, 100),      # overlaps a
              ("Stream #14(MemcpyH2D)", "copy", 300, 100),
              ("XLA Ops", "a", 0, 400)]                   # summary line
    out = trace_pool.reduce_events(events, n_rounds=2)
    assert out["launches"] == 3
    assert out["launches_per_round"] == 1.5
    assert out["busy_s"] == pytest.approx(250e-9)
    assert out["window_s"] == pytest.approx(400e-9)
    assert out["busy_share"] == pytest.approx(250 / 400)
    assert out["device_us_per_round"] == pytest.approx(0.125)
    assert out["device_lines"]["XLA Ops"] == 1
    assert list(out["top_ops_us"]) == ["a", "b", "copy"]


def test_no_stream_events_is_an_error():
    with pytest.raises(ValueError):
        trace_pool.reduce_events([("XLA Modules", "m", 0, 10)], n_rounds=1)
