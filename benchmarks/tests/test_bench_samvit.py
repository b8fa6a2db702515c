"""The SAM cell (``samvit-serve-b1``) at a tiny size on the CPU: the
manifest's entries and the driver's traffic keys, a sound run correct
under the cell's own limit, three faults planted under the timed path
caught by the same check, the counts at the cell's shapes by hand, and
the per-layer readers on the program's ``pmc.samvit.*`` spans (a traced
run of a program without them reads None and raises nothing)."""

import ast
import json
from pathlib import Path

import pytest
import torch
import torch.nn as nn

from benchmarks import run
from benchmarks.counts import samvit as counts
from benchmarks.drivers import serve, serve_samvit
from benchmarks.harness import program_spans as ps
from benchmarks.harness.common import TraceView
from benchmarks.harness.trace import Trace
from benchmarks.models import samvit as family

CELL = "samvit-serve-b1"
CPU = torch.device("cpu")
BENCH = Path(__file__).resolve().parents[1]
# a 10 × 11 token grid, padded to 12 × 12 by windows of 4: both block
# kinds and padding on both axes
TINY = {"config": {"model": {"network": "samvit", "n_layers": 4,
                             "n_hidden": 32, "n_head": 2, "mlp_dim": 64,
                             "window_size": 4, "global_attn_indexes": [1, 3],
                             "neck_chans": 16, "p_pred": False},
                   "grid": {"H": 80, "W": 22}},
        "traffic": {"check_forwards": 4, "warm_forwards": 1,
                    "trace_forwards": 2}}
NEW = ("samvit_global_attn_device_ms", "samvit_window_attn_device_ms",
       "samvit_partition_device_ms", "samvit_dense_device_ms",
       "samvit_global_attn_roofline", "samvit_window_attn_roofline",
       "mfu.samvit", "device_idle_share.samvit")


def one_run(seed=2 ** 31 + 23, trace=False):
    return run.run(CELL, seed, 0.3, trace, CPU, TINY)


# -- the faults, planted in the program's model --------------------------
def zero_rel_pos(model):
    """Every relative-position table zeroed: the bias left out."""
    with torch.no_grad():
        for blk in model.blocks:
            blk.attn.rel_pos_h.zero_()
            blk.attn.rel_pos_w.zero_()


def run_global_windowed(model):
    """The global blocks run windowed, with the central 2·window − 1 rows
    of their own tables."""
    ws = max(blk.window_size for blk in model.blocks)
    for blk in model.blocks:
        if blk.window_size == 0:
            for name in ("rel_pos_h", "rel_pos_w"):
                t = getattr(blk.attn, name)
                c = (t.shape[0] - 1) // 2
                setattr(blk.attn, name,
                        nn.Parameter(t[c - ws + 1:c + ws].detach().clone()))
            blk.window_size = ws


def mask_padded_keys(monkeypatch):
    """The padded keys of each window masked out of its softmax: the
    partition notes which slots are real, the next core masks the rest."""
    from pbml_mantle_convection_tpu_torch.models import samvit
    partition, attend = samvit.window_partition, samvit.attend
    real = {}

    def noting(x, window):
        ones = torch.ones(x.shape[:3] + (1,), dtype=x.dtype, device=x.device)
        real["slots"] = partition(ones, window)[0].flatten(1)
        return partition(x, window)

    def masked(q, k, v, rel_h, rel_w, scale):
        slots = real.pop("slots", None)
        if slots is None:
            return attend(q, k, v, rel_h, rel_w, scale)
        n, N, _ = q.shape
        _, h, w, _ = rel_h.shape
        keep = slots.repeat_interleave(n // slots.shape[0], dim=0)
        attn = ((q * scale) @ k.transpose(-2, -1)).view(n, h, w, h, w)
        attn = (attn + rel_h[..., None] + rel_w[:, :, :, None, :]).view(
            n, N, N)
        attn = attn.masked_fill(keep[:, None, :] == 0, float("-inf"))
        return torch.softmax(attn, dim=-1) @ v

    monkeypatch.setattr(samvit, "window_partition", noting)
    monkeypatch.setattr(samvit, "attend", masked)


def _on_the_model(change):
    def plant(monkeypatch):
        build = family.build

        def planted(*a, **kw):
            model, weights = build(*a, **kw)
            change(model)
            return model, weights

        monkeypatch.setattr(family, "build", planted)
    plant.__name__ = change.__name__
    return plant


FAULTS = [_on_the_model(zero_rel_pos), mask_padded_keys,
          _on_the_model(run_global_windowed)]


# -- the manifest, the traffic and the run ------------------------------
def test_manifest_entries_resolve_and_traffic_keys_are_read():
    manifest = run.load_manifest()
    w, cfg, traffic, limits = run.cell_of(manifest, CELL)
    assert w["chips"] == 1 and w["config"] == "sam-vit-b"
    assert serve_samvit.KEYS == serve.KEYS
    assert set(traffic) - {"driver"} == set(serve.KEYS)
    assert traffic["driver"] == "serve_samvit" and traffic["batch"] == 1
    assert (traffic["pool"], traffic["warm_forwards"],
            traffic["check_forwards"], traffic["trace_forwards"]) == \
        (64, 5, 8, 30)
    assert cfg["family"] == "samvit" and set(limits) == {"uv_rel_max"}
    assert cfg["reduced"] == []
    ends = {m["name"]: m for m in manifest["end_to_end"]}
    for name in ("forwards_per_s", "forward_ms_p95"):
        assert CELL in ends[name]["workloads"]
    layer = {m["name"]: m for m in manifest["per_layer"]}
    for name in NEW:
        assert layer[name]["workloads"] == [CELL]
        assert (BENCH / "metrics" / f"{name}.py").exists()


def test_sound_run_is_correct():
    r = one_run()
    assert r["correct"], r["checks"]
    assert set(r["metrics"]) == {"forwards_per_s", "forward_ms_p95",
                                 "setup_s"}
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__ for f in FAULTS])
def test_fault_is_caught(fault, monkeypatch):
    fault(monkeypatch)
    r = one_run()
    assert not r["correct"], r["checks"]


def test_traced_run_on_the_cpu_raises_nothing():
    """No device operation on the CPU: the span readers find nothing."""
    r = one_run(trace=True)
    assert r["correct"], r["checks"]
    for name in NEW[:6]:
        assert name not in r["metrics"]


def test_reference_imports_nothing_of_the_port_or_jax():
    names = set()
    for node in ast.walk(ast.parse((BENCH / "reference" / "samvit.py")
                                   .read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module.split(".")[0])
    assert names == {"__future__", "torch"}


# -- the counts at the cell's shapes -------------------------------------
def cell_dims():
    return family.dims(run.cell_of(run.load_manifest(), CELL)[1])


def test_counts_at_the_cells_shapes():
    m = cell_dims()
    assert counts.grid(m) == (16, 253) and counts.tokens(m) == 4048
    assert m["global_attn_indexes"] == (2, 5, 8, 11)
    assert counts.kinds(m) == {"window": 8, "global": 4}
    # 16 × 253 padded to 28 × 266: 2 × 19 = 38 windows of 196 slots
    assert counts.window_slots(m) == (28 * 266, 28 * 266 - 4048)
    assert counts.window_slots(m) == (7448, 3400) == (38 * 196, 3400)
    N, d = 4048, 64
    glob = 12 * N * (4 * d * N + 2 * d * (16 + 253))
    win = 12 * N * (4 * d * 196 + 2 * d * (14 + 14))
    io = 4 * N * 768 * 4
    assert counts.attention_core(m, "global") == (
        glob, io + (31 + 505) * d * 4)
    assert counts.attention_core(m, "window") == (win, io + 2 * 27 * d * 4)
    dense = 2 * N * (768 * 2304 + 768 * 768 + 2 * 768 * 3072)
    embed = 2 * N * 112 * 768
    neck = 2 * N * 768 * 256 + 2 * N * 256 * 256 * 9
    head = 2 * N * 256 * 2 * 16
    total = embed + 12 * dense + 4 * glob + 8 * win + neck + head
    assert counts.forward_flops(m) == total
    assert round(total / 1e12, 2) == 0.92
    assert round(4 * glob / 1e9, 1) == 208.0
    assert round(8 * win / 1e9, 1) == 20.9


def test_model_exposes_the_padded_slots():
    from pbml_mantle_convection_tpu_torch.models.registry import (
        ModelConfig, build_model)
    model = build_model(ModelConfig(**{**TINY["config"]["model"],
                                       "global_attn_indexes": (1, 3)},
                                    H=80, W=22), device="cpu")
    m = family.dims(TINY["config"])
    assert (model.window_slots, model.padded_slots) == \
        counts.window_slots(m) == (144, 34)


# -- the readers on a synthetic trace -------------------------------------
def span(name, a, b):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": a,
            "dur": b - a}


def op(name, a, b, corr, launch):
    return [{"ph": "X", "cat": "kernel", "name": name, "ts": a,
             "dur": b - a, "args": {"correlation": corr}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": launch, "dur": 1, "args": {"correlation": corr}}]


# one forward: a window block (pad and partition, qkv, the core with its
# rel-pos terms, output, unpartition, MLP) and a global block's core
SPANS = [span(f"pmc.samvit.{name}", a, b) for name, a, b in (
    ("forward", 0, 200), ("partition", 5, 8), ("qkv", 8, 10),
    ("attn.window", 10, 20), ("relpos", 10, 13), ("out", 20, 25),
    ("partition", 25, 28), ("mlp", 30, 40), ("attn.global", 50, 70),
    ("relpos", 50, 52), ("neck", 80, 90))]
DEVICE = (op("pad", 100, 150, 1, 6) + op("sgemm_qkv", 150, 350, 2, 9)
          + op("einsum_h", 350, 400, 3, 11) + op("bmm", 400, 700, 4, 15)
          + op("sgemm_out", 700, 800, 5, 22) + op("crop", 800, 850, 6, 26)
          + op("sgemm_mlp", 850, 1250, 7, 35)
          + op("einsum_g", 1250, 1300, 8, 51)
          + op("softmax", 1300, 3300, 9, 60) + op("conv", 3300, 3500, 10, 85)
          + op("add", 3500, 3510, 11, 150))


def view_of(events):
    cfg = run.cell_of(run.load_manifest(), CELL)[1]
    return TraceView(Trace(events), 1, 5e-3, 5e-3, {}, cfg,
                     family.dims(cfg), cfg["peaks"])


def test_readers_on_the_programs_spans(tmp_path, monkeypatch):
    monkeypatch.setattr(ps, "TRACES", tmp_path)
    events = SPANS + DEVICE
    (tmp_path / f"{CELL}.json").write_text(
        json.dumps({"traceEvents": events}))
    v = view_of(events)
    got = {n: run.reader(n)(v) for n in NEW}
    assert got["samvit_window_attn_device_ms"] == pytest.approx(0.35)
    assert got["samvit_global_attn_device_ms"] == pytest.approx(2.05)
    assert got["samvit_partition_device_ms"] == pytest.approx(0.1)
    assert got["samvit_dense_device_ms"] == pytest.approx(0.7)
    peaks, m = v.peaks, v.dims
    for kind, n, ms in (("global", 4, 2.05), ("window", 8, 0.35)):
        flops, nbytes = counts.attention_core(m, kind)
        least = max(n * flops / peaks["flops_per_s"],
                    n * nbytes / peaks["hbm_bytes_per_s"])
        assert got[f"samvit_{kind}_attn_roofline"] == pytest.approx(
            100 * least / (ms / 1e3))
    assert got["mfu.samvit"] == pytest.approx(
        100 * counts.forward_flops(m) / 5e-3 / peaks["flops_per_s"])
    assert got["device_idle_share.samvit"] == pytest.approx(
        100 * (1 - 3.41e-3 / 5e-3))


def test_a_program_without_samvit_spans_reads_none(tmp_path, monkeypatch):
    """The parent's trace has no ``pmc.samvit.*`` span: the span readers
    return None and raise nothing."""
    monkeypatch.setattr(ps, "TRACES", tmp_path)
    (tmp_path / f"{CELL}.json").write_text(
        json.dumps({"traceEvents": DEVICE}))
    v = view_of(DEVICE)
    for name in NEW[:6]:
        assert run.reader(name)(v) is None
