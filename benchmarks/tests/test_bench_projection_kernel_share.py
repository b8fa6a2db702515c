"""``projection_kernel_share`` on the program's spans: the device time
launched inside ``pmc.kernel.projection_conv`` over that inside
``pmc.attn.project``; None on a trace without the kernel's span (the
parent's, or the plain path's), and it raises nothing there."""

import json

import pytest

from benchmarks import run
from benchmarks.harness import program_spans as ps
from benchmarks.harness.common import TraceView
from benchmarks.harness.trace import Trace
from benchmarks.models import transolver as family

CELL = "transolver-serve-b1"
NAME = "projection_kernel_share"


def span(name, a, b):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": a,
            "dur": b - a}


def op(name, a, b, corr, launch):
    return [{"ph": "X", "cat": "kernel", "name": name, "ts": a,
             "dur": b - a, "args": {"correlation": corr}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": launch, "dur": 1, "args": {"correlation": corr}}]


# one block: the LayerNorm, then the projections' span; the parent ran
# cuDNN's two convs and their layout copies there, the kernel runs alone
BLOCK = [span("pmc.transolver.forward", 0, 100),
         span("pmc.transolver.norm", 2, 5), span("pmc.attn.project", 10, 30)]
KERNEL = [span("pmc.kernel.projection_conv", 12, 20)]
PARENT = (op("layer_norm", 100, 150, 1, 3)
          + op("nchwToNhwcKernel", 150, 200, 2, 11)
          + op("implicit_gemm_fprop", 200, 900, 3, 14)
          + op("nhwcToNchwKernel", 900, 1000, 4, 16))
CHANGE = (op("layer_norm", 100, 150, 1, 3)
          + op("projection_conv_kernel", 150, 550, 2, 14))


def read(tmp_path, monkeypatch, events):
    monkeypatch.setattr(ps, "TRACES", tmp_path)
    (tmp_path / f"{CELL}.json").write_text(
        json.dumps({"traceEvents": events}))
    cfg = run.cell_of(run.load_manifest(), CELL)[1]
    view = TraceView(Trace(events), 1, 2.5e-3, 2.5e-3, {}, cfg,
                     family.dims(cfg), cfg["peaks"])
    return run.reader(NAME)(view)


def test_all_of_the_span_in_the_kernel(tmp_path, monkeypatch):
    assert read(tmp_path, monkeypatch, BLOCK + KERNEL + CHANGE) == 100.0


def test_share_of_the_span_in_the_kernels_span(tmp_path, monkeypatch):
    # a copy launched in the projections' span outside the kernel's span
    events = BLOCK + KERNEL + CHANGE + op("copy", 600, 700, 5, 25)
    assert read(tmp_path, monkeypatch, events) == pytest.approx(
        100 * 400 / 500)


@pytest.mark.parametrize("spans", [BLOCK, []])
def test_none_without_the_kernels_span(tmp_path, monkeypatch, spans):
    assert read(tmp_path, monkeypatch, spans + PARENT) is None


def test_listed_for_the_transolver_cell_alone():
    m, = [m for m in run.load_manifest()["per_layer"] if m["name"] == NAME]
    assert (m["layer"], m["moves"], m["workloads"]) == (
        "kernels", "forwards_per_s", [CELL])
