"""The port's spans (``utils/profiling.py::span``), on the CPU.

* With no profiler collecting, ``span`` is one shared no-op context and
  never reaches ``record_function``.
* Under ``torch.profiler`` each layer opens its ``pmc.*`` spans, found in
  the exported Chrome trace: a fused ML_STOKES rollout (one
  ``pmc.engine.step`` per step with the input, the executor, the energy
  step and the records inside it; one ``pmc.engine.snapshot`` per
  snapshot, outside every step), a structured Transolver forward (two
  LayerNorms per block and the last block's third; one projection, slice
  attention, output Dense and MLP per block, the preprocess MLP and the
  last ``mlp2``), an ML_PRE step (the PT solve and its residual checks)
  and a train step (loss, backward, optimizer).
* ``utils.profiling.trace`` writes a trace that holds the spans.
"""

import collections
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pbml_mantle_convection_tpu_torch.constants import SimParams
from pbml_mantle_convection_tpu_torch.models.fast_path import FastNewFluidNet
from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet
from pbml_mantle_convection_tpu_torch.models.transolver import (
    TransolverStructured2D)
from pbml_mantle_convection_tpu_torch.physics.stokes import make_stokes_fn
from pbml_mantle_convection_tpu_torch.sim.engine import SimEngine
from pbml_mantle_convection_tpu_torch.sim.grid import Grid
from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper
from pbml_mantle_convection_tpu_torch.train import train_step as tts
from pbml_mantle_convection_tpu_torch.train.trainer import adam_l2
from pbml_mantle_convection_tpu_torch.utils import profiling

H, W = 20, 28
NFN = dict(levels=2, c_i=7, c_h=8, c_o=1, act_fn="gelu", r_p="learned",
           loss_type="curl", repeats=1, f=5, p_pred=False, device="cpu")
STEPS, EVERY = 6, 3
BLOCKS = 2


def spans_of(prof, tmp_path):
    """[(name, start, end)] of the ``pmc.*`` ranges in ``prof``'s
    exported Chrome trace, by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("pmc.")), key=lambda s: s[1])


def profiled(fn, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return spans_of(prof, tmp_path)


def counts(spans):
    return collections.Counter(name for name, _, _ in spans)


def inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def engine(mode="ML_STOKES", stokes_fn=None):
    grid = Grid(H=H, W=W)
    fast = FastNewFluidNet(NewFluidNet(**NFN), H, W)
    eng = SimEngine(TimeStepper(grid, SimParams(4.0, 1e7, 5.0), fast,
                                cn_max=0.99, device="cpu"),
                    mode, stokes_fn=stokes_fn)
    T0 = np.clip(1.0 - grid.yc + 0.05 * np.sin(3 * grid.xc), 0, 1)[None]
    return eng, eng.init_state(T0)


def test_span_is_a_shared_no_op_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = profiling.span("pmc.engine.step"), profiling.span("pmc.executor")
    assert a is b
    with a:
        with b:
            pass
    # the whole fused step runs through it
    eng, state = engine()
    eng.rollout(state, 2, 1)


def rollout_case(tmp_path):
    eng, state = engine()
    spans = profiled(lambda: eng.rollout(state, STEPS, EVERY), tmp_path)
    steps = [s for s in spans if s[0] == "pmc.engine.step"]
    assert len(steps) == STEPS
    for part in ("pmc.engine.input", "pmc.executor", "pmc.engine.energy",
                 "pmc.kernel.layer_stack", "pmc.kernel.trunk",
                 "pmc.kernel.epilogue"):
        found = [s for s in spans if s[0] == part]
        assert found, part
        assert all(any(inside(s, st) for st in steps) for s in found), part
    for st in steps:
        for part in ("pmc.engine.input", "pmc.executor",
                     "pmc.engine.energy", "pmc.engine.record"):
            assert any(s[0] == part and inside(s, st) for s in spans), part
    snaps = [s for s in spans if s[0] == "pmc.engine.snapshot"]
    assert len(snaps) == STEPS // EVERY
    assert not any(s[1] < st[2] and st[1] < s[2]
                   for s in snaps for st in steps)
    n = counts(spans)
    assert n["pmc.executor"] == n["pmc.kernel.trunk"] == STEPS
    assert n["pmc.kernel.layer_stack"] == 4 * STEPS
    # a step's record, then one stack per multi_step and one concat
    assert n["pmc.engine.record"] == STEPS + STEPS // EVERY + 1


def transolver_case(tmp_path):
    m = TransolverStructured2D(H=10, W=12, n_layers=BLOCKS, n_hidden=16,
                               n_head=2, slice_num=4, device="cpu")
    x = torch.randn(1, 10 * 12, 7)
    with torch.no_grad():
        spans = profiled(lambda: m(x), tmp_path)
    n = counts(spans)
    assert n["pmc.transolver.forward"] == 1
    assert n["pmc.transolver.norm"] == 2 * BLOCKS + 1
    for part in ("pmc.attn.project", "pmc.attn.slice", "pmc.attn.out",
                 "pmc.kernel.slice_pool", "pmc.kernel.slice_deslice"):
        assert n[part] == BLOCKS, part
    # every block's MLP, the preprocess MLP and the last block's mlp2
    assert n["pmc.transolver.mlp"] == BLOCKS + 2
    fwd = next(s for s in spans if s[0] == "pmc.transolver.forward")
    assert all(inside(s, fwd) for s in spans)
    for k in ("pmc.kernel.slice_pool", "pmc.kernel.slice_deslice"):
        assert all(any(inside(s, a) for a in spans
                       if a[0] == "pmc.attn.slice")
                   for s in spans if s[0] == k)


def ml_pre_case(tmp_path):
    grid = Grid(H=H, W=W)
    eng, state = engine("ML_PRE", make_stokes_fn(grid, 4.0, n_iter=200,
                                                 pre_iter=20))
    spans = profiled(lambda: eng.multi_step(state, 2), tmp_path)
    n = counts(spans)
    assert n["pmc.engine.step"] == n["pmc.pt.solve"] == 2
    assert n["pmc.pt.check"] >= 2 * 2       # a check and its host read
    solves = [s for s in spans if s[0] == "pmc.pt.solve"]
    assert all(any(inside(s, v) for v in solves)
               for s in spans if s[0] == "pmc.pt.check")
    # no fused epilogue in ML_PRE: the energy kernel's plain version
    assert n["pmc.kernel.advect"] == 2 and n["pmc.kernel.epilogue"] == 0


def train_case(tmp_path):
    m = NewFluidNet(**{**NFN, "c_h": 4, "repeats": 2})
    rng = np.random.default_rng(3)
    batch = {"x": torch.as_tensor(rng.normal(size=(2, 16, 24, 7)),
                                  dtype=torch.float32),
             "y": torch.as_tensor(rng.normal(size=(2, 2, 16, 24)),
                                  dtype=torch.float32)}
    step = tts.make_train_step(m, adam_l2(m.parameters(), 1e-3),
                               tts.TrainStepConfig(loss_derivative=True))
    spans = profiled(lambda: step(batch), tmp_path)
    order = [s[0] for s in spans if s[0].startswith("pmc.train.")]
    assert order == ["pmc.train.loss", "pmc.train.backward",
                     "pmc.train.optimizer"]


@pytest.mark.parametrize("case", [rollout_case, transolver_case,
                                  ml_pre_case, train_case],
                         ids=["rollout", "transolver", "ml_pre", "train"])
def test_layers_open_their_spans(case, tmp_path):
    case(tmp_path)


def test_trace_holds_the_program_spans(tmp_path):
    eng, state = engine()
    d = tmp_path / "trace"
    with profiling.trace(str(d)):
        eng.multi_step(state, 2)
    (name,) = os.listdir(d)
    events = json.loads((d / name).read_text())["traceEvents"]
    names = collections.Counter(e["name"] for e in events
                                if e.get("cat") == "user_annotation")
    assert names["pmc.engine.step"] == 2 and names["pmc.executor"] == 2
    # and nothing stays on once the trace is written
    assert profiling.span("pmc.engine.step") is profiling.span("pmc.x")
