"""The reduction of a traced window: busy time inside each kind of the
benchmark's spans, and idle gaps cut at the spans' edges."""

import pytest

from portbench.trace import reduce


def ev(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def test_spans_and_gaps():
    span = "user_annotation"
    events = [
        ev("portbench.window", 0, 1000, span),
        ev("portbench.wait", 0, 100, span),
        ev("portbench.merge", 100, 400, span),
        ev("portbench.check", 500, 200, span),
        ev("portbench.wait", 700, 300, span),
        ev("k1", 150, 50, "kernel"),
        ev("copy", 180, 40, "gpu_memcpy"),  # overlaps k1
        ev("k1", 300, 100, "kernel"),
    ]
    t = reduce(events)
    assert t["window_s"] == pytest.approx(1e-3)
    assert t["busy_s"] == pytest.approx(170e-6)
    assert t["memcpy_s"] == pytest.approx(40e-6)
    assert t["span_s"] == pytest.approx(
        {"wait": 400e-6, "merge": 400e-6, "check": 200e-6})
    assert t["span_busy_s"] == pytest.approx(
        {"wait": 0.0, "merge": 170e-6, "check": 0.0})
    gaps = dict((n, s) for n, s in t["idle_gaps"])
    # Idle time is cut where the merge, the check and the wait end and
    # begin; the harness's waits and checks are left out, and the merge's
    # host work before its first device operation is its start.
    assert gaps == pytest.approx({
        "merge:start": 50e-6,
        "merge:after_copy": 80e-6,
        "merge:after_k1": 100e-6})
    assert sum(s for _, s in t["idle_gaps"]) == pytest.approx(
        t["window_s"] - t["busy_s"] - t["span_s"]["wait"]
        - t["span_s"]["check"])
