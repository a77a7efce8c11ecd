"""The traced window: ``torch.profiler`` over the window of a
``--trace 1`` run, reduced from its Chrome trace to what the per-layer
readers and the result's ``breakdown`` take.

Device activity is every event of the categories ``kernel``,
``gpu_memcpy`` and ``gpu_memset``; the busy time is the length of their
union inside the window.  The host's spans are the benchmark's own
``record_function`` ranges (``portbench.*``, around its calls into the
program, its checks and its waits): the busy time inside each kind of
span is kept apart, and an idle gap is cut at their edges and each
piece named by the span it lies in and the device operation before
it.  The idle gaps listed leave out the harness's waits and checks.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "portbench."
WINDOW_SPAN = "portbench.window"
# The benchmark's own spans between the program's calls (a schedule's
# wait for the next unit, the check of a unit's output): the card idles
# there by design, so their idle time is not listed among the gaps.
HARNESS_SPANS = ("wait", "check")


class Profiler:
    """Start and stop ``torch.profiler`` around a window; ``summary``
    holds the reduction once it has stopped."""

    def __init__(self, workdir: str, cuda: bool):
        self.path = os.path.join(workdir, "trace.json")
        self.cuda = cuda
        self.prof = None
        self.span = None
        self.summary: Optional[dict] = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.span = record_function(WINDOW_SPAN)

    def open_window(self):
        """Mark the window's start (the profiler may start earlier)."""
        self.span.__enter__()

    def stop(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.span.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.prof.export_chrome_trace(self.path)
        with open(self.path) as f:
            events = json.load(f)
        os.unlink(self.path)
        self.summary = reduce(events.get("traceEvents", events)
                              if isinstance(events, dict) else events)


def span(name: str):
    """A host span of the benchmark's own, seen by the traced window."""
    from torch.profiler import record_function

    return record_function(SPAN_PREFIX + name)


def _merge(intervals: List[Tuple[float, float, str]]):
    out: List[List] = []
    for lo, hi, name in sorted(intervals):
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1][1], out[-1][2] = hi, name
        else:
            out.append([lo, hi, name])
    return out


def _short(name: str) -> str:
    return name.replace(" ", "_")[:64]


def _overlap(a: float, b: float, busy: List[List]) -> float:
    """Microseconds of ``busy`` (merged, sorted) inside [a, b)."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for lo, hi, _ in busy
               if hi > a and lo < b)


def reduce(events: List[dict]) -> dict:
    """Busy and window seconds, memcpy seconds, device seconds by
    operation name, the seconds of each of the benchmark's spans and
    the device's busy seconds inside them, the top device operations
    and the longest idle gaps of a Chrome trace's events (times in
    microseconds).  An idle gap is cut where a span begins or ends, and
    each piece is named by the span it lies in (``window`` where none)
    and by the device operation before it, or ``start`` where it opens
    its span; pieces inside the harness's own spans are left out."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
             for e in xs if e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(SPAN_PREFIX)]
    win = [s for s in spans if s[2] == WINDOW_SPAN]
    spans = sorted(s for s in spans if s[2] != WINDOW_SPAN)
    dev = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]),
            str(e.get("name", "")), e.get("cat"))
           for e in xs if e.get("cat") in DEVICE_CATS]
    if win:
        lo, hi = win[0][0], win[0][1]
    elif dev:
        lo, hi = min(d[0] for d in dev), max(d[1] for d in dev)
    else:
        return {"busy_s": 0.0, "window_s": 0.0, "memcpy_s": 0.0,
                "by_name": {}, "span_s": {}, "span_busy_s": {},
                "device_ops": [], "idle_gaps": []}
    clipped = [(max(a, lo), min(b, hi), n, c) for a, b, n, c in dev
               if b > lo and a < hi]
    by_name: Dict[str, float] = {}
    memcpy = 0.0
    for a, b, n, c in clipped:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
        if c == "gpu_memcpy":
            memcpy += (b - a) / 1e6
    merged = _merge([(a, b, n) for a, b, n, _ in clipped])
    busy = sum(b - a for a, b, _ in merged) / 1e6
    span_s: Dict[str, float] = {}
    span_busy: Dict[str, float] = {}
    for a, b, n in spans:
        a, b, n = max(a, lo), min(b, hi), n[len(SPAN_PREFIX):]
        if b > a:
            span_s[n] = span_s.get(n, 0.0) + (b - a) / 1e6
            span_busy[n] = span_busy.get(n, 0.0) + _overlap(a, b,
                                                            merged) / 1e6
    cuts = sorted({t for a, b, _ in spans for t in (a, b) if lo < t < hi})
    gaps = []
    prev_end, prev_name = lo, "window_start"
    for a, b, n in merged + [[hi, hi, "window_end"]]:
        if a > prev_end:
            edges = [prev_end] + [t for t in cuts if prev_end < t < a] + [a]
            for g0, g1 in zip(edges, edges[1:]):
                holders = [s for s in spans if s[0] <= g0 < s[1]]
                where = (holders[-1][2][len(SPAN_PREFIX):] if holders
                         else "window")
                # A piece that starts where its span starts is the host's
                # work before the span's first device operation.
                what = ("start" if g0 > prev_end
                        else f"after_{_short(prev_name)}")
                if where not in HARNESS_SPANS:
                    gaps.append((f"{where}:{what}", (g1 - g0) / 1e6))
        if b > prev_end:
            prev_end, prev_name = b, n
    gaps.sort(key=lambda g: -g[1])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy, "window_s": (hi - lo) / 1e6, "memcpy_s": memcpy,
            "by_name": by_name, "span_s": span_s, "span_busy_s": span_busy,
            "device_ops": [[_short(n), s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in gaps[:10]]}
