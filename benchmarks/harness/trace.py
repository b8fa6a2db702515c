"""Device trace of a traced stretch, read from ``torch.profiler``'s
Chrome trace, and the spans the benchmark opens around calls into the
program.

A span is a ``torch.profiler.record_function`` range named ``bench.<x>``
that the benchmark's own code opens around a call into one layer of the
program (:func:`span_calls`). A device operation belongs to a span when
the host call that launched it (matched by the profiler's correlation
id) ran inside that span. Device time is the sum of the operations'
durations on the device; busy time is the union of their intervals.
"""

from __future__ import annotations

import contextlib
import json
from bisect import bisect_right
from collections import defaultdict
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Trace:
    """What one profiled stretch left on the device and the host.

    ``ops``: device operations as (name, start µs, duration µs,
    correlation id); ``spans``: host spans as name → [(start, end)];
    ``launch_ts``: correlation id → host time of the launch call;
    ``cpu_ops``: host operations as (start, end, name), for labelling
    idle gaps."""

    def __init__(self, events: list):
        self.ops, self.cpu_ops = [], []
        self.spans = defaultdict(list)
        self.launch_ts = {}
        for e in events:
            cat = e.get("cat", "")
            if e.get("ph") != "X":
                continue
            ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                self.ops.append((e["name"], ts, dur,
                                 args.get("correlation")))
            elif cat == "cuda_runtime" or cat == "cuda_driver":
                if "correlation" in args:
                    self.launch_ts[args["correlation"]] = ts
            elif cat == "user_annotation" and e["name"].startswith("bench."):
                self.spans[e["name"]].append((ts, ts + dur))
            elif cat == "cpu_op":
                self.cpu_ops.append((ts, ts + dur, e["name"]))
        self.ops.sort(key=lambda o: o[1])

    @classmethod
    def from_profiler(cls, prof, path: Path) -> "Trace":
        path.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        return cls(events)

    # -- whole stretch ------------------------------------------------
    def device_s(self) -> float:
        """Summed durations of every device operation, seconds."""
        return sum(o[2] for o in self.ops) / 1e6

    def busy_s(self) -> float:
        """Union of the device operations' intervals, seconds."""
        busy, end = 0.0, None
        for _, ts, dur, _ in self.ops:
            if end is None or ts >= end:
                busy += dur
                end = ts + dur
            elif ts + dur > end:
                busy += ts + dur - end
                end = ts + dur
        return busy / 1e6

    def top_ops(self, n: int = 10) -> list:
        """[(name, seconds)] of the device operations that took most
        time, summed by name."""
        by = defaultdict(float)
        for name, _, dur, _ in self.ops:
            by[name] += dur / 1e6
        return sorted(([k[:120], v] for k, v in by.items()),
                      key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """[(what the host was doing, seconds)] of the longest gaps
        between device operations; a gap is named by the innermost host
        operation or span running at its middle."""
        gaps, end = [], None
        for _, ts, dur, _ in self.ops:
            if end is not None and ts > end:
                gaps.append((ts - end, end, ts))
            end = ts + dur if end is None else max(end, ts + dur)
        gaps.sort(reverse=True)
        host = sorted(self.cpu_ops) + sorted(
            (a, b, k) for k, v in self.spans.items() for a, b in v)
        out = []
        for gap, a, b in gaps[:n]:
            mid, best = 0.5 * (a + b), None
            for s, e, name in host:
                if s <= mid <= e and (best is None
                                      or e - s < best[1] - best[0]):
                    best = (s, e, name)
            out.append([best[2][:120] if best else "host", gap / 1e6])
        return out

    # -- spans --------------------------------------------------------
    def span_ops(self, name: str) -> list:
        """The device operations launched inside span ``name``; None when
        the span never opened, or when no launch could be matched to its
        host call (the launch records are missing)."""
        ranges = sorted(self.spans.get(name, ()))
        if not ranges:
            return None
        starts = [r[0] for r in ranges]
        out, matched = [], 0
        for op in self.ops:
            ts = self.launch_ts.get(op[3])
            if ts is None:
                continue
            matched += 1
            i = bisect_right(starts, ts) - 1
            if i >= 0 and ts <= ranges[i][1]:
                out.append(op)
        return out if matched else None

    def span_device_s(self, name: str):
        ops = self.span_ops(name)
        return None if not ops else sum(o[2] for o in ops) / 1e6

    def span_count(self, name: str) -> int:
        return len(self.spans.get(name, ()))


@contextlib.contextmanager
def span_calls(owner, attr: str, span: str):
    """Within the block, ``owner.attr`` (a module's function or an
    object's method) runs inside a ``record_function(span)`` range; it
    is put back afterwards. The benchmark's way to mark a call into one
    layer of the program without editing the program."""
    import torch

    orig = getattr(owner, attr)
    own = attr in vars(owner)

    def wrapped(*args, **kw):
        with torch.profiler.record_function(span):
            return orig(*args, **kw)

    # a function's own attributes (the program's launch counters, which
    # it bumps through the name it is called by) go on the wrapper, and
    # back onto the function with what they counted meanwhile
    extra = dict(getattr(orig, "__dict__", {}))
    wrapped.__dict__.update(extra)
    setattr(owner, attr, wrapped)
    try:
        yield
    finally:
        if own:
            setattr(owner, attr, orig)
        else:
            delattr(owner, attr)
        for k in extra:
            setattr(orig, k, wrapped.__dict__[k])
