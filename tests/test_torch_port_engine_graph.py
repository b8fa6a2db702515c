"""``SimEngine.multi_step``'s CUDA graph of a fused ML_STOKES chunk.

On the card (marked ``cuda``; they skip without one, and the file imports
no JAX): replayed chunks against the eager loop from the same start, to
the bit; a returned state left as it was by later chunks; the kernel
wrappers' launch counters; the eager chunk under a profiler; and the
engines the graph does not apply to (GAIA, ML_PRE, B = 2). Run them with

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_port_engine_graph.py

On the CPU: the gate's reason for each eager case, the step counters, and
the benchmark's reader of them (``benchmarks/metrics/graph_step_share.py``).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pbml_mantle_convection_tpu_torch.constants import SimParams
from pbml_mantle_convection_tpu_torch.models import fast_path
from pbml_mantle_convection_tpu_torch.models.fast_path import FastNewFluidNet
from pbml_mantle_convection_tpu_torch.models.fluidnet import NewFluidNet
from pbml_mantle_convection_tpu_torch.physics.stokes import make_stokes_fn
from pbml_mantle_convection_tpu_torch.sim.engine import COUNTED, SimEngine
from pbml_mantle_convection_tpu_torch.sim.grid import Grid
from pbml_mantle_convection_tpu_torch.sim.stepper import TimeStepper

ROOT = Path(__file__).resolve().parents[1]
PARAMS = SimParams(raq=3.0, fkt=1e8, fkp=10.0)
CHUNK = 10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _engine(device, H, W, mode="ML_STOKES", fused=True, small=False,
            process_group=None, decay=False):
    """The flagship (``small``: 2 levels, 8 channels, 1 repeat) on an H × W
    grid, through the fused executor or its module, with the PT solve
    that GAIA and ML_PRE take and radioactive decay when ``decay``; and
    the initial temperature."""
    grid = Grid(H=H, W=W, aspect=(W - 2) / (H - 2))
    dims = (dict(levels=2, c_h=8, repeats=1) if small
            else dict(levels=5, c_h=16, repeats=6))
    model = NewFluidNet(c_i=7, c_o=1, act_fn="gelu", r_p="learned",
                        loss_type="curl", f=5, p_pred=False, seed=0,
                        device=device, **dims)
    fn = FastNewFluidNet(model, H, W) if fused else model
    stokes = (make_stokes_fn(grid, PARAMS.raq, n_iter=20, pre_iter=10)
              if mode in ("GAIA", "ML_PRE") else None)
    eng = SimEngine(TimeStepper(grid, PARAMS, fn, cn_max=0.99,
                                device=device),
                    mode, stokes_fn=stokes, process_group=process_group,
                    radioactive_decay=decay)
    T0 = np.clip(1.0 - grid.yc + 0.05 * np.sin(6.28 * grid.xc), 0.0, 1.0)
    return eng, T0[None]


def _launches():
    return [f.launches for f in COUNTED]


def _assert_same(a, b):
    """Every field of two states (or traces) equal to the bit."""
    for name in a._fields:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x, y), name


@pytest.mark.cuda
@pytest.mark.parametrize("decay", [False, True])
def test_cuda_replayed_chunks_match_the_eager_loop(cuda, decay):
    """Two chunks capture the graph; the next three replay it, each equal
    to the eager loop's chunk from the same state to the bit (T, u, v, V,
    t, dt, n_step and the records), with the wrappers' counters moving as
    the eager loop moves them; with radioactive decay too, whose heating
    reads t on the card."""
    eng, T0 = _engine(cuda, 128, 506, decay=decay)
    state = eng.init_state(T0)
    for _ in range(2):
        state, _ = eng.multi_step(state, CHUNK)
    assert [c.graph is not None for c in eng._graphs.values()] == [True]
    g0, e0 = SimEngine.graph_steps, SimEngine.eager_steps
    for _ in range(3):
        n0 = _launches()
        want = eng._steps(state, CHUNK)
        n1 = _launches()
        got = eng.multi_step(state, CHUNK)
        n2 = _launches()
        torch.cuda.synchronize()
        _assert_same(got[0], want[0])
        _assert_same(got[1], want[1])
        assert torch.isfinite(got[0].T).all()
        assert [b - a for a, b in zip(n0, n1)] == [b - a for a, b in
                                                   zip(n1, n2)]
        assert n2[0] - n1[0] == 4 * CHUNK and n2[1] - n1[1] == CHUNK
        state = got[0]
    assert SimEngine.graph_steps - g0 == 3 * CHUNK
    assert SimEngine.eager_steps == e0


@pytest.mark.cuda
def test_cuda_returned_state_is_left_as_it_was(cuda):
    """A chunk's returned state and records, and the state it started
    from, keep their values through the chunks that replay after them."""
    eng, T0 = _engine(cuda, 128, 506)
    start = eng.init_state(T0)
    chunks = [eng.multi_step(start, CHUNK)]
    kept = [[x.clone() for x in part] for part in (start, *chunks[0])]
    for _ in range(4):
        chunks.append(eng.multi_step(chunks[-1][0], CHUNK))
    again = eng.multi_step(chunks[0][0], CHUNK)
    torch.cuda.synchronize()
    for part, copy in zip((start, *chunks[0]), kept):
        assert all(torch.equal(x, y) for x, y in zip(part, copy))
    _assert_same(again[0], chunks[1][0])
    _assert_same(again[1], chunks[1][1])
    assert [c.graph is not None for c in eng._graphs.values()] == [True]


@pytest.mark.cuda
def test_cuda_profiled_chunk_runs_eagerly(cuda, monkeypatch):
    """Under ``torch.profiler`` a chunk whose graph exists runs eagerly:
    a span around the executor's ``layer_stack`` calls (as the benchmark
    opens) sees four calls per step."""
    from torch.profiler import ProfilerActivity, profile
    eng, T0 = _engine(cuda, 128, 506)
    state = eng.init_state(T0)
    for _ in range(3):
        state, _ = eng.multi_step(state, CHUNK)
    calls = []
    for name in ("layer_stack", "layer_stacks"):
        orig = getattr(fast_path, name)

        def wrapped(*a, _orig=orig, **kw):
            with torch.profiler.record_function("bench.layer_stack"):
                calls.append(1)
                return _orig(*a, **kw)
        monkeypatch.setattr(fast_path, name, wrapped)
    g0, e0 = SimEngine.graph_steps, SimEngine.eager_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]):
        profiled, _ = eng.multi_step(state, CHUNK)
        torch.cuda.synchronize()
    assert len(calls) == 4 * CHUNK
    assert SimEngine.graph_steps == g0
    assert SimEngine.eager_steps == e0 + CHUNK
    replayed, _ = eng.multi_step(state, CHUNK)
    assert len(calls) == 4 * CHUNK
    assert SimEngine.graph_steps == g0 + CHUNK
    torch.cuda.synchronize()
    assert torch.equal(profiled.T, replayed.T)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["GAIA", "ML_PRE", "B2"])
def test_cuda_engines_without_the_fused_chunk_never_capture(cuda, case):
    H, W = 32, 48
    mode = case if case != "B2" else "ML_STOKES"
    eng, T0 = _engine(cuda, H, W, mode=mode, small=True)
    if case == "B2":
        T0 = np.concatenate([T0, T0[:, ::-1]])
    state = eng.init_state(T0)
    assert eng._eager_reason(state) is not None
    g0 = SimEngine.graph_steps
    for _ in range(3):
        state, _ = eng.multi_step(state, 2)
    torch.cuda.synchronize()
    assert torch.isfinite(state.T).all()
    assert eng._graphs == {} and SimEngine.graph_steps == g0


@pytest.fixture
def world_of_one():
    """A gloo process group of this process alone."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case,reason", [
    ("cpu", "not one float32 simulation on the card"),
    ("module", "not the fused epilogue"),
    ("group", "a process group"),
    ("profiler", "a profiler is collecting")])
def test_gate_runs_the_chunk_eagerly(case, reason, request):
    """Each case the graph does not apply to, on the CPU: the gate's
    reason, and a chunk that runs eagerly and captures nothing."""
    group = (request.getfixturevalue("world_of_one") if case == "group"
             else None)
    eng, T0 = _engine("cpu", 20, 28, fused=case != "module", small=True,
                      process_group=group)
    state = eng.init_state(T0)
    g0, e0 = SimEngine.graph_steps, SimEngine.eager_steps
    if case == "profiler":
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CPU]):
            got = eng._eager_reason(state)
            state, _ = eng.multi_step(state, 2)
    else:
        got = eng._eager_reason(state)
        state, _ = eng.multi_step(state, 2)
    assert got == reason
    assert eng._graphs == {}
    assert (SimEngine.graph_steps, SimEngine.eager_steps) == (g0, e0 + 2)


def test_step_counters_on_a_cpu_rollout():
    eng, T0 = _engine("cpu", 20, 28, small=True)
    state = eng.init_state(T0)
    g0, e0 = SimEngine.graph_steps, SimEngine.eager_steps
    state, _ = eng.multi_step(state, 3)
    state = eng.step(state)
    state, trace, snaps = eng.rollout(state, 6, snapshot_every=4)
    assert len(trace.dt) == 6 and len(snaps) == 2
    assert SimEngine.eager_steps - e0 == 3 + 1 + 6
    assert SimEngine.graph_steps == g0
    assert int(state.n_step) == 10


def _reader():
    path = ROOT / "benchmarks" / "metrics" / "graph_step_share.py"
    spec = importlib.util.spec_from_file_location("graph_step_share", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def test_graph_step_share_reader(monkeypatch):
    """The share of the process's steps that replayed, in %; None where
    the program has no counters (a commit before them) or ran no step."""
    read = _reader()
    monkeypatch.setattr(SimEngine, "graph_steps", 270)
    monkeypatch.setattr(SimEngine, "eager_steps", 30)
    assert read(None) == pytest.approx(90.0)
    monkeypatch.setattr(SimEngine, "graph_steps", 0)
    monkeypatch.setattr(SimEngine, "eager_steps", 0)
    assert read(None) is None
    monkeypatch.delattr(SimEngine, "graph_steps")
    monkeypatch.delattr(SimEngine, "eager_steps")
    assert read(None) is None
