"""SimEngine — the coupled mantle-convection rollout on the card.

Counterpart of the JAX package's ``sim/engine.py`` (reference rollout
script: advect_wi_gaia.py:538-833) for the fluidnet surrogates and for no
surrogate. Modes (advect_wi_gaia.py:218-222):

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
cooling, and with the fused executor (``models/fast_path.py``) as the
surrogate, the step is instead 8 ``layer_stack`` + 1 ``trunk`` + 1
``curl_advect_epilogue`` kernel calls plus a few elementwise ops. Nothing
in a step of the surrogate modes reads a value back to the host, so
:meth:`SimEngine.multi_step` queues N steps without a round trip; the PT
solve reads its residual once per ``check_every`` iterations, and the
momentum skip counts steps on the host (one read of ``n_step`` per
``multi_step``).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..constants import COORD_SCALE
from ..ops.advect_kernel import advect_diffuse_step_fused
from ..ops.epilogue_kernel import curl_advect_epilogue, epilogue_consts
from ..ops.stencils import stamp_temperature_bc
from ..physics.advection import viscous_dissipation
from ..physics.viscosity import fk_viscosity
from .stepper import TimeStepper

MODES = ("ML", "ML_STOKES", "ML_PRE", "GAIA")
# 4-component radioactive-decay constants (prepare_gaia_ini.py:81-92).
DECAY_LAMBDAS = (14.200767386369366, 90.1668042856123,
                 4.534102158362219, 50.78194417365685)
DECAY_COEFFS = (0.130448695228009, 0.2345333106414419,
                0.07981198571490902, 0.55520600841564)
CORE_RHOCP_VAR = 0.7058823529411765  # Core/rhoCpVar (prepare_gaia_ini.py:91)


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


def decay_heating(raq: float, t: torch.Tensor, radioactive_decay: bool):
    """Internal heating at time t: RaQ·Σ c_i exp(-λ_i t) with decay on,
    else RaQ (GAIA RadioactiveDecay module, prepare_gaia_ini.py:81-92).
    A 0-d tensor on t's device."""
    if not radioactive_decay:
        return torch.full((), raq, dtype=t.dtype, device=t.device)
    lam = torch.tensor(DECAY_LAMBDAS, dtype=t.dtype, device=t.device)
    cf = torch.tensor(DECAY_COEFFS, dtype=t.dtype, device=t.device)
    return raq * torch.sum(cf * torch.exp(-lam * t))


class SimEngine:
    """The coupled rollout (module docstring); runs where its stepper
    runs. ``stokes_fn`` (e.g. ``physics/stokes.py::make_stokes_fn``) is
    required by the GAIA and ML_PRE modes; the other modes use the
    stepper's surrogate."""

    def __init__(self, stepper: TimeStepper, mode: str = "ML_STOKES",
                 intervene_ts: int = 1, radioactive_decay: bool = False,
                 core_cool: bool = False, Di: float = 0.0,
                 stokes_fn: Optional[Callable] = None):
        if mode not in MODES:
            raise ValueError(f"mode={mode!r}: one of {MODES}")
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
        # the momentum skip reads n_step (host counter in multi_step)
        self._skip = mode == "GAIA" and intervene_ts > 1
        # GAIA's FK viscosity is unclipped; depth 1 - yc on the device
        self._depth = 1.0 - stepper._static.yc_feat * COORD_SCALE
        # the fused epilogue covers ML/ML_STOKES with Di = 0 and no core
        # cooling, when the surrogate is the fused executor (stokes_psi
        # also gates B = 1 per step)
        self._epi = None
        fn = stepper.apply_fn
        if (mode in ("ML", "ML_STOKES") and Di == 0.0 and not core_cool
                and hasattr(fn, "apply_psi_from_T")):
            self._epi = epilogue_consts(stepper._metrics, fn.m.a_bound,
                                        stepper.cn_max)

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
            return self.stepper._raq
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
                       u, v, V, self.stepper._metrics))
        return src

    @torch.no_grad()
    def step(self, state: SimState) -> SimState:
        """One coupled step."""
        return self._step(state, int(state.n_step) if self._skip else 0)

    def _step(self, state: SimState, n_step: int) -> SimState:
        """One coupled step; ``n_step`` is the state's step counter, read
        on the host (used by the momentum skip only)."""
        T = state.T
        if self._epi is not None:
            sp = self.stepper.stokes_psi(T)
            if sp is not None:
                psi, V, s = sp
                u, v, T_new, dt = curl_advect_epilogue(
                    psi[0], T[0], self._epi, s, self._source(state))
                return SimState(
                    T=T_new[None], u=u[None], v=v[None], p=state.p, V=V,
                    t=state.t + dt, dt=dt, n_step=state.n_step + 1,
                    T_core=state.T_core)

        if self.mode == "GAIA":
            V = fk_viscosity(self.params.fkt, self.params.fkp, self._depth, T)
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

        src = self._energy_sources(state, T, u, v, V)
        T_new, dt = advect_diffuse_step_fused(
            u, v, T, src, self.stepper._metrics, cn_max=self.stepper.cn_max,
            core_cool=self.core_cool)

        T_core = state.T_core
        if self.core_cool:
            # the CMB temperature falls with the mean upward conductive
            # flux between the CMB (row 0) and the first cell centre, dy/2
            # above it, scaled by Core/rhoCpVar (prepare_gaia_ini.py:70-71)
            q_cmb = torch.mean(
                (state.T_core - T_new[..., 1, :]) / (0.5 * self.grid.dy))
            T_core = T_core - dt * CORE_RHOCP_VAR * q_cmb
            T_new[..., 0, :] = T_core

        T_new = stamp_temperature_bc(T_new, core_cool=self.core_cool)
        T_new = torch.clamp(T_new, 0.0, 2.0)
        return SimState(T=T_new, u=u, v=v, p=p, V=V, t=state.t + dt, dt=dt,
                        n_step=state.n_step + 1, T_core=T_core)

    @torch.no_grad()
    def multi_step(self, state: SimState, n_steps: int):
        """n_steps coupled steps queued without a host round trip (the PT
        solve's residual checks aside); returns the final state and the
        per-step scalar trace (stacked device tensors)."""
        n0 = int(state.n_step) if self._skip else 0
        mean_T, ts, dts = [], [], []
        for k in range(n_steps):
            state = self._step(state, n0 + k)
            mean_T.append(state.T.mean())
            ts.append(state.t)
            dts.append(state.dt)
        return state, RolloutTrace(torch.stack(mean_T), torch.stack(ts),
                                   torch.stack(dts))

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
            snapshots.append({name: getattr(state, name).cpu().numpy()
                              for name in ("T", "u", "v", "p", "V", "t")})
            done += k
        trace = RolloutTrace(*(torch.cat(x) for x in zip(*traces)))
        return state, trace, snapshots
