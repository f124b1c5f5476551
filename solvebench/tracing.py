"""The benchmark's own spans, the profiler window, and the reduction of
the device trace to busy time, the top device operations and the
longest idle gaps.

The harness records spans around its calls into the program on the
host clock (``time.perf_counter_ns``).  A traced window runs under
``torch.profiler`` with CUDA activity only: the device's kernels, copies
and the host's CUDA runtime calls, with no per-operator host events, so
tracing adds little host time.  One ``torch.cuda.synchronize()`` at the
window's start is found again in the trace as its
``cudaDeviceSynchronize`` runtime event, which puts the host spans on
the trace's clock; an idle gap is then named by the span that covered
it.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ANCHOR = "cudaDeviceSynchronize"
TOP = 10


class Spans:
    """(name, start ns, end ns) of the harness's host work."""

    def __init__(self):
        self.spans: list = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.perf_counter_ns()))


def merge(intervals) -> list:
    """The union of (start, end) intervals, sorted and disjoint."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def reduce_events(events, window, spans=(), offset_ns=None) -> dict:
    """Busy seconds, the top device operations and the longest idle gaps
    of a chrome-trace event list within ``window`` = (start, end) in
    trace microseconds.  ``spans`` are host spans in perf_counter ns,
    put on the trace's clock by ``offset_ns`` (None: gaps are named
    "host")."""
    w0, w1 = window
    ivs, by_name = [], {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATS:
            continue
        s = float(ev["ts"])
        e = s + float(ev.get("dur", 0.0))
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        ivs.append((s, e))
        name = str(ev.get("name", "?"))[:64]
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-6
    busy = merge(ivs)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    gaps, prev = [], w0
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if w1 > prev:
        gaps.append((prev, w1))
    host = []
    if offset_ns is not None:
        host = [(n, (a + offset_ns) * 1e-3, (b + offset_ns) * 1e-3)
                for n, a, b in spans]
    named = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]:
        mid = 0.5 * (s + e)
        cover = [(b - a, n) for n, a, b in host if a <= mid <= b]
        named.append([min(cover)[1] if cover else "host", (e - s) * 1e-6])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": busy_s, "window_s": (w1 - w0) * 1e-6,
            "device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


class Profiled:
    """A profiler window over the cell's timed loop, or nothing.

    ``mark_start()`` and ``mark_end()`` bracket the window on the host;
    after the ``with``, ``record`` holds ``reduce_events``' record (None
    untraced).  The exported trace is written under ``TMPDIR`` and
    deleted once read."""

    def __init__(self, enabled: bool, spans: Spans):
        self.enabled = enabled
        self.spans = spans
        self._prof = None
        self.t0 = self.t1 = None
        self.record = None

    def __enter__(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile
            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    def mark_start(self):
        self.t0 = time.perf_counter_ns()
        if self.enabled:
            import torch
            torch.cuda.synchronize()

    def mark_end(self):
        self.t1 = time.perf_counter_ns()

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        import torch
        torch.cuda.synchronize()
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        fd, path = tempfile.mkstemp(prefix="solvebench-trace-",
                                    suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        anchors = [float(ev["ts"]) for ev in events
                   if ev.get("cat") == "cuda_runtime"
                   and ev.get("name") == ANCHOR]
        if anchors and self.t0 is not None:
            # the first synchronize after the profiler started is the
            # window's: the host stamped t0 just before calling it
            offset = min(anchors) * 1e3 - self.t0
            window = (self.t0 * 1e-3 + offset * 1e-3,
                      self.t1 * 1e-3 + offset * 1e-3)
        else:
            offset = None
            dev = [(float(ev["ts"]), float(ev["ts"]) + float(
                ev.get("dur", 0.0))) for ev in events
                if ev.get("cat") in DEVICE_CATS]
            span = (self.t1 - self.t0) * 1e-3
            start = min(s for s, _ in dev) if dev else 0.0
            window = (start, start + span)
        self.record = reduce_events(events, window, self.spans.spans,
                                    offset)
        return False


def idle_pct(ctx) -> float | None:
    """100 x the traced window's share with nothing on the device."""
    tr = ctx.get("trace")
    if not tr or not tr["window_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
