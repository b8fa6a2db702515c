"""The readers of the program's own spans (``benchmarks/harness/
program_spans.py``), on synthetic Chrome trace events: device idle split
by overlap over host spans, device operations per span by correlation
id, host seconds per span; finding the traced run's file; and that the
program's ``pmc.*`` events leave every reading of the benchmark's
``bench.*`` spans and every other reader's value as it was."""

import importlib
import json
import math

import pytest

from benchmarks import run
from benchmarks.harness import program_spans as ps
from benchmarks.harness.common import TraceView
from benchmarks.harness.trace import Trace

NEW = ("step_device_ops", "executor_host_ms", "enqueue_idle_ms",
       "snapshot_idle_ms", "layernorm_device_ms", "dense_device_ms")


def span(name, a, b, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a}


def op(name, a, b, corr, launch, cat="kernel"):
    """A device operation on [a, b] and the host call that launched it."""
    return [{"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a,
             "args": {"correlation": corr}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": launch, "dur": 2, "args": {"correlation": corr}}]


# two steps (a host gap of 10 µs between them) and a snapshot; four
# device operations: A, B launched in step 1, C in step 2, the copy D in
# the snapshot. Gaps between them: [90, 130] (10 in step 1, 10 in no
# span, 20 in step 2) and [160, 210] (40 in step 2, 10 in the snapshot)
PMC = [span("pmc.engine.step", 0, 100), span("pmc.engine.step", 110, 200),
       span("pmc.executor", 5, 60), span("pmc.executor", 115, 150),
       span("pmc.engine.snapshot", 200, 250),
       # what the profiler draws for a range on the device's timeline
       span("pmc.engine.step", 20, 90, cat="gpu_user_annotation")]
DEVICE = (op("A", 20, 50, 1, 10) + op("B", 50, 90, 2, 30)
          + op("C", 130, 160, 3, 120)
          + op("D", 210, 240, 4, 205, cat="gpu_memcpy"))
# the benchmark's own spans around calls, one more operation (launched in
# step 2) and a host operation
BENCH = op("E", 162, 168, 5, 140) + [
    span("bench.executor", 8, 58), span("bench.executor", 118, 148),
    span("bench.layer_stack", 9, 40), span("bench.trunk", 28, 35),
    span("bench.layer_stack", 119, 140), span("bench.pt_solve", 0, 99),
    span("bench.projection", 9, 31), span("bench.slice_pool", 116, 125),
    span("bench.slice_deslice", 126, 147),
    {"ph": "X", "cat": "cpu_op", "name": "aten::empty", "ts": 95, "dur": 30}]


def view_of(events, units=2, cfg=None):
    counters = {"host_enqueue_ms": 0.7, "pt_iterations_per_step": 200.0,
                "adam_ms": 9.0, "backward_ms": 90.0, "batch": 8}
    cfg = cfg or run.cell_of(run.load_manifest(),
                             "flagship-rollout-b1")[1]
    dims = importlib.import_module(
        f"benchmarks.models.{cfg['family']}").dims(cfg)
    return TraceView(Trace(events), units, 300e-6, 125e-6, counters, cfg,
                     dims, cfg["peaks"])


def test_idle_is_split_by_overlap():
    t = Trace(DEVICE)
    spans = ps.spans_of(PMC + DEVICE)
    assert ps.idle_s(t, spans["pmc.engine.step"]) == pytest.approx(70e-6)
    assert ps.idle_s(t, spans["pmc.engine.snapshot"]) == pytest.approx(10e-6)
    both = spans["pmc.engine.step"] + spans["pmc.engine.snapshot"]
    assert ps.idle_s(t, both) == pytest.approx(80e-6)   # 10 in no span
    assert ps.idle_s(t, [(0, 1)]) == 0.0


def test_device_operations_per_span_by_correlation():
    t = Trace(DEVICE)
    spans = ps.spans_of(PMC)
    names = lambda ops: [o[0] for o in ops]    # noqa: E731
    assert names(ps.ops_in(t, spans["pmc.engine.step"])) == ["A", "B", "C"]
    assert names(ps.ops_in(t, spans["pmc.executor"])) == ["A", "B", "C"]
    assert names(ps.ops_in(t, spans["pmc.engine.snapshot"])) == ["D"]
    assert ps.ops_in(t, []) is None
    # no launch record: nothing can be matched
    no_launch = [e for e in DEVICE if e["cat"] != "cuda_runtime"]
    assert ps.ops_in(Trace(no_launch), spans["pmc.engine.step"]) is None
    # a span nested in one of its name counts once
    nested = spans["pmc.engine.step"] + [(10, 40)]
    assert len(ps.ops_in(t, nested)) == 3


def test_host_seconds_per_span():
    spans = ps.spans_of(PMC)
    assert ps.host_s(spans["pmc.engine.step"]) == pytest.approx(190e-6)
    assert ps.host_s(spans["pmc.executor"]) == pytest.approx(90e-6)
    assert ps.host_s([(0, 10), (5, 20)]) == pytest.approx(20e-6)
    # the device timeline's copy of a range is no host span
    assert ps.spans_of([PMC[-1]]) == {}


def write(tmp_path, name, events):
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return path


def test_readers_find_the_traced_runs_file(tmp_path, monkeypatch):
    monkeypatch.setattr(ps, "TRACES", tmp_path)
    events = PMC + DEVICE
    v = view_of(events)
    assert ps.of(v) == {}                          # no file yet
    write(tmp_path, "this", events)
    # a newer file of another run (other device operations) is passed over
    other = write(tmp_path, "other", PMC[:1] + op("X", 5, 6, 9, 1))
    other.touch()
    assert set(ps.of(v)) == {"pmc.engine.step", "pmc.executor",
                             "pmc.engine.snapshot"}
    got = {n: run.reader(n)(v) for n in NEW}
    assert got["step_device_ops"] == 1.5            # A, B, C over 2 steps
    assert got["executor_host_ms"] == pytest.approx(0.045)
    assert got["enqueue_idle_ms"] == pytest.approx(0.035)
    assert got["snapshot_idle_ms"] == pytest.approx(0.005)
    assert got["layernorm_device_ms"] is None       # no such span here
    assert got["dense_device_ms"] is None


def test_a_program_without_spans_reads_none(tmp_path, monkeypatch):
    """The parent commit's traced run: the same trace with no ``pmc.*``
    span; every new reader returns None and raises nothing."""
    monkeypatch.setattr(ps, "TRACES", tmp_path)
    events = DEVICE + BENCH
    write(tmp_path, "parent", events)
    for cfg_cell in ("flagship-rollout-b1", "transolver-serve-b1"):
        cfg = run.cell_of(run.load_manifest(), cfg_cell)[1]
        v = view_of(events, cfg=cfg)
        assert all(run.reader(n)(v) is None for n in NEW)


def readings(trace: Trace) -> dict:
    out = {"ops": trace.ops, "spans": dict(trace.spans),
           "launch_ts": trace.launch_ts, "cpu_ops": trace.cpu_ops,
           "device_s": trace.device_s(), "busy_s": trace.busy_s(),
           "top_ops": trace.top_ops(), "idle_gaps": trace.idle_gaps()}
    for name in {e["name"] for e in BENCH if e["name"][:6] == "bench."}:
        out[name] = (trace.span_ops(name), trace.span_device_s(name),
                     trace.span_count(name))
    return out


def value(name, v):
    try:
        return run.reader(name)(v)
    except KeyError as e:           # a reader of another cell's config
        return type(e).__name__


def same(a, b):
    return a == b or (isinstance(a, float) and math.isnan(a)
                      and math.isnan(b))


@pytest.mark.parametrize("cell", ["flagship-rollout-b1",
                                  "transolver-serve-b1"])
def test_program_spans_move_no_benchmark_reading(cell):
    base = DEVICE + BENCH
    assert readings(Trace(base)) == readings(Trace(base + PMC))
    cfg = run.cell_of(run.load_manifest(), cell)[1]
    old = sorted(p.stem for p in (run.HERE / "metrics").glob("*.py")
                 if p.stem not in NEW)
    assert len(old) >= 18
    for name in old:
        a = value(name, view_of(base, cfg=cfg))
        b = value(name, view_of(base + PMC, cfg=cfg))
        assert same(a, b), name
