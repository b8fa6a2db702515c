"""``vit_attention_kernel_share`` on the program's spans: the device time
launched inside ``pmc.kernel.dense_attention`` over that inside
``pmc.vit.attn.core``; None on a trace without the kernel's span (the
parent's, or the plain path's), and it raises nothing there."""

import json

import pytest

from benchmarks import run
from benchmarks.harness import program_spans as ps
from benchmarks.harness.common import TraceView
from benchmarks.harness.trace import Trace
from benchmarks.models import vit as family

CELL = "vit-serve-b1"
NAME = "vit_attention_kernel_share"


def span(name, a, b):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": a,
            "dur": b - a}


def op(name, a, b, corr, launch):
    return [{"ph": "X", "cat": "kernel", "name": name, "ts": a,
             "dur": b - a, "args": {"correlation": corr}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": launch, "dur": 1, "args": {"correlation": corr}}]


# one block: the kernel launched inside its span inside the core's, a
# copy launched in the core outside the kernel's span, and the qkv GEMM
CORE = [span("pmc.vit.forward", 0, 100), span("pmc.vit.qkv", 5, 10),
        span("pmc.vit.attn.core", 10, 30)]
KERNEL = [span("pmc.kernel.dense_attention", 14, 20)]
DEVICE = (op("sgemm_qkv", 100, 200, 1, 6) + op("copy", 200, 300, 2, 12)
          + op("dense_attention_kernel", 300, 1200, 3, 16))


def read(tmp_path, monkeypatch, events):
    monkeypatch.setattr(ps, "TRACES", tmp_path)
    (tmp_path / f"{CELL}.json").write_text(
        json.dumps({"traceEvents": events}))
    cfg = run.cell_of(run.load_manifest(), CELL)[1]
    view = TraceView(Trace(events), 1, 2.5e-3, 2.5e-3, {}, cfg,
                     family.dims(cfg), cfg["peaks"])
    return run.reader(NAME)(view)


def test_share_of_the_core_in_the_kernels_span(tmp_path, monkeypatch):
    got = read(tmp_path, monkeypatch, CORE + KERNEL + DEVICE)
    assert got == pytest.approx(100 * 900 / 1000)


@pytest.mark.parametrize("spans", [CORE, []])
def test_none_without_the_kernels_span(tmp_path, monkeypatch, spans):
    assert read(tmp_path, monkeypatch, spans + DEVICE) is None


def test_listed_for_the_vit_cell_alone():
    m, = [m for m in run.load_manifest()["per_layer"] if m["name"] == NAME]
    assert (m["layer"], m["moves"], m["workloads"]) == (
        "kernels", "forwards_per_s", [CELL])
