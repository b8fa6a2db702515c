"""The program's own spans in a traced run, and what the device did
inside them.

The program opens ``record_function`` ranges named ``pmc.<layer>[.<part>]``
while a profiler collects (``pbml_mantle_convection_tpu_torch/utils/
profiling.py::span``). They sit in the traced run's Chrome trace as
``user_annotation`` events, on the clock of the device operations, so the
rules of :class:`~benchmarks.harness.trace.Trace` apply to them: a device
operation belongs to a span when the host call that launched it ran
inside the span. :class:`Trace` keeps the benchmark's ``bench.*`` spans
only; this module reads the ``pmc.*`` ones from the same file, which
``run.py`` writes to ``build/bench_traces/<cell>.json`` before any reader
runs.

A program that opens no such span (an older commit) leaves nothing to
read, and every per-unit helper then returns None. The ranges of one name
are merged first, so a span nested in another of its name counts once.
"""

from __future__ import annotations

import copy
import json
from collections import defaultdict
from pathlib import Path

from .trace import DEVICE_CATS, Trace

PREFIX = "pmc."
TRACES = Path(__file__).resolve().parents[2] / "build" / "bench_traces"
_files = {}    # (path, mtime, size) -> (device ops, first start, spans)


def spans_of(events: list) -> dict:
    """name -> merged, sorted [(start µs, end µs)] of the program's spans
    among Chrome trace events."""
    raw = defaultdict(list)
    for e in events:
        if (e.get("ph") == "X" and e.get("cat") == "user_annotation"
                and e.get("name", "").startswith(PREFIX)):
            ts = float(e.get("ts", 0.0))
            raw[e["name"]].append((ts, ts + float(e.get("dur", 0.0))))
    return {k: merge(v) for k, v in raw.items()}


def merge(ranges) -> list:
    """The union of ``ranges`` as sorted, disjoint (start, end) pairs."""
    out = []
    for a, b in sorted(ranges):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def _read(path: Path):
    st = path.stat()
    key = (str(path), st.st_mtime_ns, st.st_size)
    if key not in _files:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        starts = [float(e.get("ts", 0.0)) for e in events
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
        _files[key] = (len(starts), min(starts, default=None),
                       spans_of(events))
    return _files[key]


def of(view, traces=None) -> dict:
    """The program's spans of the traced run that ``view`` reads: those of
    the newest trace file in ``traces`` (default :data:`TRACES`) whose
    device operations are the view's (their count and first start); {}
    where none is found."""
    traces = Path(traces or TRACES)
    ops = view.trace.ops
    first = ops[0][1] if ops else None
    paths = sorted(traces.glob("*.json"), key=lambda p: p.stat().st_mtime,
                   reverse=True) if traces.is_dir() else []
    for path in paths:
        n, start, spans = _read(path)
        if n == len(ops) and start == first:
            return spans
    return {}


# -- one trace, given ranges (µs) ---------------------------------------
def host_s(ranges) -> float:
    """Seconds of host time inside ``ranges``."""
    return sum(b - a for a, b in merge(ranges)) / 1e6


def idle_s(trace, ranges) -> float:
    """Seconds in which the device ran nothing while the host was inside
    ``ranges``: each gap between device operations (after the union of
    the operations before it) counts for the part of it that the ranges
    cover, so a gap that runs from one span into the next is split."""
    gaps, end = [], None
    for _, ts, dur, _ in trace.ops:
        if end is not None and ts > end:
            gaps.append((end, ts))
        end = ts + dur if end is None else max(end, ts + dur)
    rs, i, idle = merge(ranges), 0, 0.0
    for a, b in gaps:
        while i < len(rs) and rs[i][1] <= a:
            i += 1
        j = i
        while j < len(rs) and rs[j][0] < b:
            idle += min(b, rs[j][1]) - max(a, rs[j][0])
            j += 1
    return idle / 1e6


def ops_in(trace, ranges):
    """The device operations whose launch ran inside ``ranges``; None when
    there is no range, or when no launch could be matched to its host
    call (the launch records are missing): ``Trace.span_ops`` over the
    merged ranges."""
    one = copy.copy(trace)
    one.spans = {"": merge(ranges)}
    return Trace.span_ops(one, "")


# -- per unit of a traced run ---------------------------------------------
def _ranges(view, names):
    spans = of(view)
    got = [r for n in names for r in spans.get(n, ())]
    return got or None


def host_ms(view, *names):
    """Host milliseconds per unit inside the spans ``names``."""
    rs = _ranges(view, names)
    return None if rs is None else 1e3 * host_s(rs) / view.units


def idle_ms(view, *names):
    """Device-idle milliseconds per unit while the host was inside the
    spans ``names``."""
    rs = _ranges(view, names)
    return None if rs is None else 1e3 * idle_s(view.trace, rs) / view.units


def device_ms(view, *names):
    """Device milliseconds per unit of the operations launched inside the
    spans ``names``."""
    ops = ops_in(view.trace, _ranges(view, names) or ())
    return None if not ops else sum(o[2] for o in ops) / 1e3 / view.units


def op_count(view, *names):
    """Device operations per unit launched inside the spans ``names``."""
    ops = ops_in(view.trace, _ranges(view, names) or ())
    return None if ops is None else len(ops) / view.units
