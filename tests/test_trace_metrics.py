"""The trace-to-metrics reduction (benchmarks/trace_metrics.py) on
hand-made device timelines, so every run computes busy/idle share and gaps
the same way."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmarks"))
import trace_metrics as tm  # noqa: E402


def test_union_merges_overlapping_and_touching_intervals():
    assert tm.intervals_union([(5, 7), (0, 2), (1, 3), (3, 4)]) == \
        [[0, 4], [5, 7]]


def test_busy_idle_and_gaps_in_window():
    # two streams overlap on [10, 20) and [15, 30); one kernel at [60, 70)
    ev = [("k1", 10, 10), ("k2", 15, 15), ("k3", 60, 10)]
    m = tm.window_metrics(ev, 0, 100)
    assert m["busy_ns"] == 30
    assert m["idle_share"] == pytest.approx(0.7)
    assert [g["gap_ns"] for g in m["longest_gaps_ns"]] == [30, 30, 10]
    assert m["longest_gaps_ns"][0]["at_ns"] in (30, 70)


def test_events_clipped_to_window():
    m = tm.window_metrics([("k", -5, 10), ("k", 95, 10)], 0, 100)
    assert m["busy_ns"] == 10


@pytest.mark.parametrize("name,want", [
    ("MemcpyDtoH", "copy_d2h"), ("Memcpy HtoD", "copy_h2d"),
    ("Memset", "copy_other"), ("loop_fusion_3", "kernel")])
def test_event_kind(name, want):
    assert tm.kind(name) == want
