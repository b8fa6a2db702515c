"""The ViT cell (``vit-serve-b1``) at a tiny size on the CPU: the
driver's traffic keys, a sound run correct under the cell's own limit,
two faults planted under the timed path caught by the same check, and
the per-layer readers on the program's ``pmc.vit.*`` spans (a traced run
of a program without them reads None and raises nothing)."""

import json

import pytest
import torch

from benchmarks import run
from benchmarks.drivers import serve, serve_vit
from benchmarks.harness import program_spans as ps
from benchmarks.harness.common import TraceView
from benchmarks.harness.trace import Trace
from benchmarks.models import vit as family

CELL = "vit-serve-b1"
CPU = torch.device("cpu")
TINY = {"config": {"model": {"network": "vit", "n_layers": 2,
                             "n_hidden": 48, "n_head": 3, "mlp_dim": 192,
                             "p_pred": False},
                   "grid": {"H": 16, "W": 20}},
        "traffic": {"check_forwards": 4, "warm_forwards": 1,
                    "trace_forwards": 2}}
NEW = ("vit_attention_device_ms", "vit_attention_roofline",
       "vit_dense_device_ms", "mfu.vit", "device_idle_share.vit")


def one_run(seed=2 ** 31 + 23, trace=False):
    return run.run(CELL, seed, 0.3, trace, CPU, TINY)


def test_traffic_keys_are_the_serve_drivers():
    _, cfg, traffic, limits = run.cell_of(run.load_manifest(), CELL)
    assert serve_vit.KEYS == serve.KEYS
    assert set(traffic) - {"driver"} == set(serve.KEYS)
    assert traffic["driver"] == "serve_vit" and traffic["batch"] == 1
    assert cfg["family"] == "vit" and set(limits) == {"uv_rel_max"}


def test_sound_run_is_correct():
    r = one_run()
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"forwards_per_s", "forward_ms_p95",
                                 "setup_s"}
    assert r["attempted"] > 0 and r["failed"] == 0


class _Unscaled:
    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def softmax(x, dim):
        return torch.softmax(x * 8.0, dim=dim)


def unscaled(monkeypatch):
    from pbml_mantle_convection_tpu_torch.models import vit
    monkeypatch.setattr(vit, "torch", _Unscaled())


def mean_pooled(monkeypatch):
    build = family.build

    def planted(*a, **kw):
        model, weights = build(*a, **kw)
        model.vit.pool = "mean"
        return model, weights

    monkeypatch.setattr(family, "build", planted)


@pytest.mark.parametrize("fault", [unscaled, mean_pooled],
                         ids=["scale_left_out", "mean_pooling"])
def test_fault_is_caught(fault, monkeypatch):
    fault(monkeypatch)
    r = one_run()
    assert not r["correct"], r["checks"]


def test_traced_run_on_the_cpu_raises_nothing():
    """No device operation on the CPU: the span readers find nothing."""
    r = one_run(trace=True)
    assert r["correct"], r["checks"]
    for name in ("vit_attention_device_ms", "vit_attention_roofline",
                 "vit_dense_device_ms"):
        assert name not in r["metrics"]


def span(name, a, b):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": a,
            "dur": b - a}


def op(name, a, b, corr, launch):
    return [{"ph": "X", "cat": "kernel", "name": name, "ts": a,
             "dur": b - a, "args": {"correlation": corr}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": launch, "dur": 1, "args": {"correlation": corr}}]


# one forward: the qkv GEMM, the scores and softmax, the output
# projection, the MLP and the head, each launched inside its span
SPANS = [span("pmc.vit.forward", 0, 100), span("pmc.vit.qkv", 5, 10),
         span("pmc.vit.attn.core", 10, 30), span("pmc.vit.attn.out", 30, 35),
         span("pmc.vit.mlp", 40, 50), span("pmc.vit.head", 80, 90)]
DEVICE = (op("sgemm_qkv", 100, 200, 1, 6) + op("bmm", 200, 1200, 2, 12)
          + op("softmax", 1200, 1600, 3, 20) + op("sgemm_out", 1600, 1700, 4, 31)
          + op("sgemm_mlp", 1700, 2000, 5, 41) + op("gemv", 2000, 2010, 6, 85)
          + op("add", 2010, 2020, 7, 60))


def view_of(events):
    cfg = run.cell_of(run.load_manifest(), CELL)[1]
    return TraceView(Trace(events), 1, 2.5e-3, 2.5e-3, {}, cfg,
                     family.dims(cfg), cfg["peaks"])


def test_readers_on_the_programs_spans(tmp_path, monkeypatch):
    monkeypatch.setattr(ps, "TRACES", tmp_path)
    events = SPANS + DEVICE
    (tmp_path / f"{CELL}.json").write_text(
        json.dumps({"traceEvents": events}))
    v = view_of(events)
    got = {n: run.reader(n)(v) for n in NEW}
    assert got["vit_attention_device_ms"] == pytest.approx(1.4)
    assert got["vit_dense_device_ms"] == pytest.approx(0.51)
    peaks = v.peaks
    least = max(12 * 2 * 2 * 12 * 4049 ** 2 * 64 / peaks["flops_per_s"],
                12 * 4 * 4049 * 768 * 4 / peaks["hbm_bytes_per_s"])
    assert got["vit_attention_roofline"] == pytest.approx(
        100 * least / 1.4e-3)
    assert got["mfu.vit"] == pytest.approx(
        100 * 1.293059395584e12 / 2.5e-3 / peaks["flops_per_s"])
    assert got["device_idle_share.vit"] == pytest.approx(
        100 * (1 - 1.92e-3 / 2.5e-3))


def test_a_program_without_vit_spans_reads_none(tmp_path, monkeypatch):
    """The parent's trace has no ``pmc.vit.*`` span: the span readers
    return None and raise nothing."""
    monkeypatch.setattr(ps, "TRACES", tmp_path)
    (tmp_path / f"{CELL}.json").write_text(
        json.dumps({"traceEvents": DEVICE}))
    v = view_of(DEVICE)
    for name in NEW[:3]:
        assert run.reader(name)(v) is None
