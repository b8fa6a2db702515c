"""SimEngine — the coupled mantle-convection rollout on the card.

Counterpart of the JAX package's ``sim/engine.py`` (reference rollout
script: advect_wi_gaia.py:538-833) for the fluidnet surrogates, the U-Net
and no surrogate. Modes (advect_wi_gaia.py:218-222):

* ``ML_STOKES`` (and ``ML``, which coincides with it in-framework) — the
  surrogate's velocities drive the explicit energy step every step;
* ``ML_PRE`` — the surrogate's prediction warm-starts a short PT momentum
  solve (``stokes_fn``), whose velocities drive the energy step;
* ``GAIA`` — no surrogate: the converged PT solve (``stokes_fn``) on the
  unclipped FK viscosity; with ``intervene_ts`` > 1 momentum is solved
  only every ``intervene_ts``-th step and the stale velocities are reused
  in between (GAIA's MMSolverSkip, prepare_gaia_ini.py:152).

Options: radioactive decay of the internal heating, core cooling (the CMB
temperature falls with the heat flux through the bottom boundary,
prepare_gaia_ini.py:70-71, 91) and the extended-Boussinesq terms for a
dissipation number ``Di`` > 0 (prepare_gaia_ini.py:61-62).

Per step: the Stokes solve, the energy sources, the energy step
(``ops/advect_kernel.py``: one CUDA call on the card), core cooling, BC
stamping and the clip to [0, 2]. In ML/ML_STOKES with Di = 0 and no core
cooling, and with the fused executor (``models/fast_path.py``) of a
plain curl head (no ``blurr``, no ``p_pred``) as the surrogate, the step
is instead 4 ``layer_stack`` (stem, the grouped branches, merges 2 and
3) + 1 ``trunk`` + 1 ``curl_advect_epilogue`` kernel calls plus a few
elementwise ops; with ``blurr``, ``p_pred`` or the ``mae``/``mass``
heads the executor's 4 + 1, the module's head and the energy step
(4 + 1 + 0 + 1). Nothing
in a step of the surrogate modes reads a value back to the host, so
:meth:`SimEngine.multi_step` queues N steps without a round trip; the PT
solve reads its residual once per ``check_every`` iterations, and the
momentum skip counts steps on the host (one read of ``n_step`` per
``multi_step``). A stepper with ``net`` "unet" or "iunet" outside GAIA
runs :meth:`SimEngine.step_unet` instead: the network advances u, v and T
together, with dt from the driver's CFL rule, and no energy step runs.

With a ``process_group`` the batch is split over its ranks and advances
as the single-process batch does (JAX: ``jit`` of ``multi_step`` over a
batch-sharded state): every rank's surrogate step is local, the CFL dt
of each rank's simulations is reduced over the ranks with one
``all_reduce(MIN)`` per step (dt is a decreasing function of the largest
velocity, so the minimum is the dt of the whole batch) and the energy
step takes that shared dt, a device tensor (no host read). The fused
epilogue forms its dt inside its kernel, so this rollout takes the
energy-kernel path at any local batch: 4B ``layer_stack`` + B ``trunk``
+ 0 + 1 ``advect_diffuse_step_fused`` per step for the flagship. Core
cooling reduces its CMB flux over the ranks too (a second all-reduce),
and the mean-T trace is reduced over the global batch once per
:meth:`SimEngine.multi_step`. The PT solve of the GAIA and ML_PRE modes
checks its own residual, so those modes refuse a group. Without a group
nothing changes.

A bfloat16 state (the JAX CLI's ``--dtype bfloat16``) takes its energy
step in float32, the kernel's narrowest type, from the same bfloat16
values, and the new T and dt are rounded back to bfloat16.

On the card the fused step is short enough that the host's enqueue of
its ~30 launches, not the device, sets the rate. So where a chunk of
:meth:`SimEngine.multi_step` takes the fused epilogue on one float32
simulation on the card, with no process group and no profiler
collecting, the engine captures the chunk (its steps and records) as a
CUDA graph the second time it meets that chunk length, and replays it
from then on: the same kernels in the same order on copies of the
state, so the results are those of the eager loop to the bit. Every
other chunk (GAIA, ML_PRE, B > 1, a process group, the CPU, bfloat16,
the module heads) runs the eager loop. Under a profiler the chunk runs
eagerly too, so that the program's spans, and any span a caller opens
around a call into the executor or a kernel wrapper, see the calls they
wrap; the eager chunk runs the same kernels in the same order.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..models.fluidnet import plain_curl_head
from ..ops.advect_kernel import advect_diffuse_step_fused
from ..ops.branch_kernel import layer_stack
from ..ops.epilogue_kernel import curl_advect_epilogue, epilogue_consts
from ..ops.merge_kernel import trunk
from ..ops.stencils import stamp_temperature_bc
from ..physics.advection import stability_dt, viscous_dissipation
from ..physics.viscosity import fk_viscosity
from ..utils.profiling import profiling, span
from .stepper import TimeStepper

MODES = ("ML", "ML_STOKES", "ML_PRE", "GAIA")
# 4-component radioactive-decay constants (prepare_gaia_ini.py:81-92).
DECAY_LAMBDAS = (14.200767386369366, 90.1668042856123,
                 4.534102158362219, 50.78194417365685)
DECAY_COEFFS = (0.130448695228009, 0.2345333106414419,
                0.07981198571490902, 0.55520600841564)
CORE_RHOCP_VAR = 0.7058823529411765  # Core/rhoCpVar (prepare_gaia_ini.py:91)
# chunk lengths whose graphs an engine keeps: a rollout's snapshot
# interval, a probe's, a remainder
GRAPH_KEYS = 4
# the kernel wrappers whose ``.launches`` count their calls; a replay adds
# the calls its capture made
COUNTED = (layer_stack, trunk, curl_advect_epilogue,
           advect_diffuse_step_fused)
# the fields of a state that a fused step reads or passes on: a replay
# copies them into the graph's inputs (u, v, V and dt are made anew)
GRAPH_INPUTS = ("T", "p", "t", "n_step", "T_core")


class SimState(NamedTuple):
    """Device-resident simulation state (the GAIA ``getState()`` fields)."""

    T: torch.Tensor        # (B, H, W) temperature
    u: torch.Tensor        # (B, H, W)
    v: torch.Tensor        # (B, H, W)
    p: torch.Tensor        # (B, H, W)
    V: torch.Tensor        # (B, H, W) viscosity
    t: torch.Tensor        # 0-d time
    dt: torch.Tensor       # 0-d last dt
    n_step: torch.Tensor   # 0-d int step counter
    T_core: torch.Tensor   # 0-d bottom (CMB) temperature


class RolloutTrace(NamedTuple):
    """Per-step scalar records (advect_wi_gaia.py:645-652)."""

    mean_T: torch.Tensor
    t: torch.Tensor
    dt: torch.Tensor


class _Chunk(NamedTuple):
    """A chunk length met by :meth:`SimEngine.multi_step` on the card.
    ``pinned`` holds the executor and the stepper's input template,
    which the graph reads and the chunk's key names by identity. Once
    met, ``graph`` is None; once captured: the graph; ``inputs``, per dtype, its input
    tensors and the fields of ``GRAPH_INPUTS`` copied into them;
    ``outputs``, its output tensors (the state's fields, then the
    records); ``groups``, the indices of the outputs of each dtype;
    ``launches``, each ``COUNTED`` wrapper's calls in one replay."""

    pinned: tuple
    graph: Optional["torch.cuda.CUDAGraph"] = None
    inputs: tuple = ()
    outputs: tuple = ()
    groups: tuple = ()
    launches: tuple = ()


def _by_dtype(ts) -> list:
    """The indices of ``ts`` grouped by dtype."""
    groups = {}
    for i, t in enumerate(ts):
        groups.setdefault(t.dtype, []).append(i)
    return list(groups.values())


@functools.lru_cache(maxsize=None)
def _decay_consts(dtype: torch.dtype, device: torch.device):
    """(λ, c) of the decay as tensors, made once per dtype and device (a
    step copies nothing from the host, so a CUDA graph can hold it)."""
    return (torch.tensor(DECAY_LAMBDAS, dtype=dtype, device=device),
            torch.tensor(DECAY_COEFFS, dtype=dtype, device=device))


def decay_heating(raq: float, t: torch.Tensor, radioactive_decay: bool):
    """Internal heating at time t: RaQ·Σ c_i exp(-λ_i t) with decay on,
    else RaQ (GAIA RadioactiveDecay module, prepare_gaia_ini.py:81-92).
    A 0-d tensor on t's device."""
    if not radioactive_decay:
        return torch.full((), raq, dtype=t.dtype, device=t.device)
    lam, cf = _decay_consts(t.dtype, t.device)
    return raq * torch.sum(cf * torch.exp(-lam * t))


class SimEngine:
    """The coupled rollout (module docstring); runs where its stepper
    runs. ``stokes_fn`` (e.g. ``physics/stokes.py::make_stokes_fn``) is
    required by the GAIA and ML_PRE modes; the other modes use the
    stepper's surrogate.

    ``graph_steps`` and ``eager_steps`` count the steps that every engine
    of the process ran by replaying a captured chunk and eagerly."""

    graph_steps = 0
    eager_steps = 0

    def __init__(self, stepper: TimeStepper, mode: str = "ML_STOKES",
                 intervene_ts: int = 1, radioactive_decay: bool = False,
                 core_cool: bool = False, Di: float = 0.0,
                 stokes_fn: Optional[Callable] = None,
                 process_group: Optional[dist.ProcessGroup] = None):
        if mode not in MODES:
            raise ValueError(f"mode={mode!r}: one of {MODES}")
        if process_group is not None and mode in ("GAIA", "ML_PRE"):
            raise ValueError(f"mode={mode!r} over a process group: the PT "
                             "solve checks each rank's own residual")
        if mode in ("GAIA", "ML_PRE") and stokes_fn is None:
            raise ValueError(f"mode={mode!r} requires stokes_fn")
        if mode != "GAIA" and stepper.apply_fn is None:
            raise ValueError(f"mode={mode!r} needs a stepper with a "
                             "surrogate")
        self.stepper = stepper
        self.grid, self.params = stepper.grid, stepper.params
        self.mode, self.intervene_ts = mode, intervene_ts
        self.radioactive_decay, self.core_cool = radioactive_decay, core_cool
        self.Di, self.stokes_fn = Di, stokes_fn
        self.device, self.dtype = stepper.device, stepper.dtype
        self.group = process_group
        self._dx_min = stepper.metrics.dx_min
        # the energy kernel's types are float32 and float64: a bfloat16
        # state steps on float32 copies of its bfloat16 metrics
        self._metrics = stepper.metrics
        if self.dtype == torch.bfloat16:
            self._metrics = type(stepper.metrics)(
                *(m.float() for m in stepper.metrics))
        # the momentum skip reads n_step (host counter in multi_step)
        self._skip = mode == "GAIA" and intervene_ts > 1
        # the fused epilogue covers ML/ML_STOKES with Di = 0 and no core
        # cooling, when the surrogate is the fused executor of a plain
        # curl head (the epilogue takes the raw stream function: it would
        # skip a blur and drop p, and the mae/mass heads have none; JAX's
        # engine gates them off the same way, engine.py:184-188); _step
        # takes it at B = 1
        self._epi = None
        fn = stepper.executor
        if (mode in ("ML", "ML_STOKES") and Di == 0.0 and not core_cool
                and process_group is None and fn is not None
                and plain_curl_head(fn.m)):
            self._epi = epilogue_consts(stepper.metrics, fn.m.a_bound,
                                        stepper.cn_max)
        self._graphs = {}   # chunk key -> _Chunk, the newest last

    def init_state(self, T0, T_core: float = 1.0) -> SimState:
        T0 = torch.as_tensor(T0, dtype=self.dtype, device=self.device)
        if T0.ndim == 2:
            T0 = T0[None]
        z = torch.zeros_like(T0)

        def scalar(v, dtype=self.dtype):
            return torch.full((), v, dtype=dtype, device=self.device)

        return SimState(T=T0, u=z, v=z, p=z, V=torch.ones_like(T0),
                        t=scalar(0.0), dt=scalar(0.0),
                        n_step=scalar(0, torch.int32), T_core=scalar(T_core))

    def get_state(self, state: SimState) -> dict:
        """Host-side dict of the first simulation with the GAIA
        ``Direct.getState()`` contract (advect_wi_gaia.py:546-637):
        T, v (N, 3), P, V, pos, time."""
        def flat(x):
            return x[0].reshape(-1).cpu().numpy()

        u, v = flat(state.u), flat(state.v)
        return {"T": flat(state.T),
                "v": np.stack([u, v, np.zeros_like(u)], axis=1),
                "P": flat(state.p), "V": flat(state.V),
                "pos": self.grid.pos, "time": float(state.t)}

    def _source(self, state: SimState):
        if not self.radioactive_decay:
            return self.stepper.heating
        return decay_heating(self.params.raq, state.t, True)

    def _energy_sources(self, state: SimState, T, u, v, V):
        """Internal heating, plus for Di > 0 the extended-Boussinesq terms
        (GAIA MCEnergy=Boussinesq/Compress, prepare_gaia_ini.py:61-62):
        adiabatic -Di·v·(T+T0) with T0 = 0 (prepare_gaia_ini.py:125) and
        viscous dissipation +(Di/Ra)·Φ with Ra = 1
        (prepare_gaia_ini.py:117). A 0-d tensor, or (B, H-2, W-2)."""
        src = self._source(state)
        if self.Di > 0.0:
            src = (src
                   - self.Di * v[..., 1:-1, 1:-1] * T[..., 1:-1, 1:-1]
                   + self.Di * viscous_dissipation(
                       u, v, V, self.stepper.metrics))
        return src

    def _shared_dt(self, u, v):
        """The CFL dt of this rank's simulations reduced to the minimum
        over the group (a 0-d device tensor); None without a group (the
        energy step forms its own)."""
        if self.group is None:
            return None
        dt = stability_dt(u[..., 1:-1, 1:-1], v[..., 1:-1, 1:-1],
                          self._dx_min, self.stepper.cn_max)
        dist.all_reduce(dt, op=dist.ReduceOp.MIN, group=self.group)
        return dt

    def _group_mean(self, x):
        """The mean over the group of a per-rank mean (equal local
        batches: the global batch's mean); ``x`` without a group."""
        if self.group is None:
            return x
        x = x.clone()
        dist.all_reduce(x, group=self.group)
        return x / dist.get_world_size(self.group)

    def _energy_step(self, u, v, T, src, dt=None):
        """``advect_diffuse_step_fused`` with the engine's metrics; a
        bfloat16 state steps on float32 copies and the new T and dt are
        rounded back to bfloat16."""
        kw = dict(cn_max=self.stepper.cn_max, core_cool=self.core_cool)
        if T.dtype != torch.bfloat16:
            return advect_diffuse_step_fused(u, v, T, src, self._metrics,
                                             dt=dt, **kw)

        def f32(t):
            return t.float() if torch.is_tensor(t) else t

        T_new, dt = advect_diffuse_step_fused(
            f32(u), f32(v), f32(T), f32(src), self._metrics, dt=f32(dt),
            **kw)
        return T_new.to(T.dtype), dt.to(T.dtype)

    @torch.no_grad()
    def step(self, state: SimState) -> SimState:
        """One coupled step."""
        SimEngine.eager_steps += 1
        with span("pmc.engine.step"):
            return self._step(state, int(state.n_step) if self._skip else 0)

    def step_unet(self, state: SimState) -> SimState:
        """One coupled U-Net step: the network advances (u, v, T)
        jointly; dt comes from the driver-level CFL rule
        (advect_wi_gaia.py:734-797, ``attempt_unet``)."""
        s = self.stepper.scaler
        u_prev, v_prev = state.u / s, state.v / s
        dt = self.stepper.unet_dt(u_prev, v_prev)
        if self.group is not None:
            dist.all_reduce(dt, op=dist.ReduceOp.MIN, group=self.group)
        p_prev = state.p if self.stepper.unet_p_pred else None
        T_new, u, v, p, V = self.stepper.step_unet(state.T, u_prev, v_prev,
                                                   dt, p_prev=p_prev)
        if p is None:
            p = state.p
        return SimState(T=T_new, u=u, v=v, p=p, V=V, t=state.t + dt, dt=dt,
                        n_step=state.n_step + 1, T_core=state.T_core)

    def _step(self, state: SimState, n_step: int) -> SimState:
        """One coupled step; ``n_step`` is the state's step counter, read
        on the host (used by the momentum skip only)."""
        if self.stepper.net in ("unet", "iunet") and self.mode != "GAIA":
            return self.step_unet(state)
        T = state.T
        if self._epi is not None and T.shape[0] == 1:
            psi, V = self.stepper.stokes_psi(T)
            with span("pmc.engine.energy"):
                u, v, T_new, dt = curl_advect_epilogue(
                    psi[0], T[0], self._epi, self.stepper.scaler,
                    self._source(state))
                return SimState(
                    T=T_new[None], u=u[None], v=v[None], p=state.p, V=V,
                    t=state.t + dt, dt=dt, n_step=state.n_step + 1,
                    T_core=state.T_core)

        if self.mode == "GAIA":
            V = fk_viscosity(self.params.fkt, self.params.fkp,
                             self.stepper.static.depth, T)
            if n_step % self.intervene_ts == 0:
                u, v, p = self.stokes_fn(T, V)
            else:
                u, v, p = state.u, state.v, state.p
        elif self.mode == "ML_PRE":
            u_s, v_s, p_s, V = self.stepper.stokes(T)
            if p_s is None:
                p_s = state.p
            u, v, p = self.stokes_fn(T, V, (u_s, v_s, p_s))
        else:
            u, v, p, V = self.stepper.stokes(T)
            if p is None:
                p = state.p

        with span("pmc.engine.energy"):
            src = self._energy_sources(state, T, u, v, V)
            T_new, dt = self._energy_step(u, v, T, src,
                                          self._shared_dt(u, v))

            T_core = state.T_core
            if self.core_cool:
                # the CMB temperature falls with the mean upward conductive
                # flux between the CMB (row 0) and the first cell centre,
                # dy/2 above it, scaled by Core/rhoCpVar
                # (prepare_gaia_ini.py:70-71)
                q_cmb = self._group_mean(torch.mean(
                    (state.T_core - T_new[..., 1, :]) / (0.5 * self.grid.dy)))
                T_core = T_core - dt * CORE_RHOCP_VAR * q_cmb
                T_new[..., 0, :] = T_core

            T_new = stamp_temperature_bc(T_new, core_cool=self.core_cool)
            T_new = torch.clamp(T_new, 0.0, 2.0)
            return SimState(T=T_new, u=u, v=v, p=p, V=V, t=state.t + dt,
                            dt=dt, n_step=state.n_step + 1, T_core=T_core)

    @torch.no_grad()
    def multi_step(self, state: SimState, n_steps: int):
        """n_steps coupled steps queued without a host round trip (the PT
        solve's residual checks aside); returns the final state and the
        per-step scalar trace (stacked device tensors: the three records
        of every step in one stack).

        Where :meth:`_eager_reason` finds none, the chunk replays a CUDA
        graph (module docstring): the first chunk of a length runs
        eagerly, the second is the warm-up of its capture and the later
        ones replay it. The returned tensors are new ones each call: a
        later replay never writes to them."""
        if self._eager_reason(state) is not None:
            SimEngine.eager_steps += n_steps
            return self._steps(state, n_steps)
        pinned = (self.stepper.executor, self.stepper.template)
        T = state.T
        key = (n_steps, tuple(T.shape), T.dtype, T.device,
               *(id(x) for x in pinned))
        chunk = self._graphs.pop(key, None)
        if chunk is not None and chunk.graph is not None:
            SimEngine.graph_steps += n_steps
            out = self._replay(chunk, state)
        else:
            SimEngine.eager_steps += n_steps
            if chunk is None:
                chunk = _Chunk(pinned=pinned)
                out = self._steps(state, n_steps)
            else:
                out, chunk = self._capture(chunk.pinned, state, n_steps)
        self._graphs[key] = chunk
        while len(self._graphs) > GRAPH_KEYS:
            del self._graphs[next(iter(self._graphs))]
        return out

    def _eager_reason(self, state: SimState) -> Optional[str]:
        """Why :meth:`multi_step` runs ``state``'s chunk eagerly; None
        where it replays a CUDA graph."""
        if self.group is not None:
            return "a process group"
        if self._epi is None:
            return "not the fused epilogue"
        if profiling():
            return "a profiler is collecting"
        T = state.T
        if not T.is_cuda or T.dtype != torch.float32 or T.shape[0] != 1:
            return "not one float32 simulation on the card"
        if torch.cuda.is_current_stream_capturing():
            return "a capture is running"
        return None

    def _capture(self, pinned: tuple, state: SimState, n_steps: int):
        """The chunk's eager run on a side stream, its result returned,
        which warms up the capture of the same chunk on static copies of
        ``state`` (``torch.cuda.graph``'s rules). The capture launches
        nothing, so the wrappers' counters are put back after it."""
        main = torch.cuda.current_stream(state.T.device)
        side = torch.cuda.Stream(state.T.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            out = self._steps(state, n_steps)
        main.wait_stream(side)
        for t in (*out[0], *out[1]):
            t.record_stream(main)
        static = SimState(*(x.clone() for x in state))
        before = [f.launches for f in COUNTED]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            st, tr = self._steps(static, n_steps)
        launches = tuple(f.launches - n for f, n in zip(COUNTED, before))
        for f, n in zip(COUNTED, before):
            f.launches = n
        ins = [getattr(static, f) for f in GRAPH_INPUTS]
        inputs = tuple(([ins[i] for i in idx], [GRAPH_INPUTS[i] for i in idx])
                       for idx in _by_dtype(ins))
        outs = (*st, *tr)
        return out, _Chunk(pinned, graph, inputs, outs, _by_dtype(outs),
                           launches)

    @staticmethod
    def _replay(chunk: _Chunk, state: SimState):
        """``state``'s ``GRAPH_INPUTS`` copied into the graph's inputs,
        one replay, and the outputs copied into new tensors, one
        multi-tensor copy per dtype each way (on the card's host, half the
        time of a clone per field)."""
        for dsts, names in chunk.inputs:
            torch._foreach_copy_(dsts, [getattr(state, n) for n in names])
        chunk.graph.replay()
        for f, n in zip(COUNTED, chunk.launches):
            f.launches += n
        outs = chunk.outputs
        fresh = [torch.empty_like(x) for x in outs]
        for idx in chunk.groups:
            torch._foreach_copy_([fresh[i] for i in idx],
                                 [outs[i] for i in idx])
        k = len(SimState._fields)
        return SimState(*fresh[:k]), RolloutTrace(*fresh[k:])

    def _steps(self, state: SimState, n_steps: int):
        """The eager loop of :meth:`multi_step`."""
        n0 = int(state.n_step) if self._skip else 0
        mean_T, ts, dts = [], [], []
        for k in range(n_steps):
            with span("pmc.engine.step"):
                state = self._step(state, n0 + k)
                with span("pmc.engine.record"):
                    mean_T.append(state.T.mean())
                    ts.append(state.t)
                    dts.append(state.dt)
        with span("pmc.engine.record"):
            rec = torch.stack(mean_T + ts + dts).view(3, n_steps)
            return state, RolloutTrace(self._group_mean(rec[0]), rec[1],
                                       rec[2])

    def rollout(self, state: SimState, n_steps: int,
                snapshot_every: Optional[int] = None):
        """Run ``n_steps``; with ``snapshot_every`` copy the full fields to
        the host every that many steps. Returns (state, trace, snapshots)."""
        if not snapshot_every:
            state, trace = self.multi_step(state, n_steps)
            return state, trace, []
        snapshots, traces, done = [], [], 0
        while done < n_steps:
            k = min(snapshot_every, n_steps - done)
            state, tr = self.multi_step(state, k)
            traces.append(tr)
            with span("pmc.engine.snapshot"):
                snapshots.append({name: getattr(state, name).cpu().numpy()
                                  for name in ("T", "u", "v", "p", "V", "t")})
            done += k
        if len(traces) == 1:
            return state, traces[0], snapshots
        with span("pmc.engine.record"):
            trace = RolloutTrace(*(torch.cat(x) for x in zip(*traces)))
        return state, trace, snapshots
