"""SimEngine — the coupled ML_STOKES mantle-convection rollout on the card.

Counterpart of the ML_STOKES mode of the JAX package's ``sim/engine.py``
(reference rollout script: advect_wi_gaia.py:538-833): per step the surrogate
Stokes solve, velocity unscaling, the explicit energy step, BC stamping
and the clip to [0, 2]. With the fused executor
(``models/fast_path.py``) the step is 8 ``layer_stack`` + 1 ``trunk`` +
1 ``curl_advect_epilogue`` kernel calls plus a few elementwise ops for
the input channels. Nothing in a step reads a value back to the host, so
:meth:`SimEngine.multi_step` queues N steps without a round trip; only
the trace is read after the loop.

The other modes (ML, ML_PRE, GAIA), Di > 0, core cooling and B > 1 on the
fused path are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.epilogue_kernel import curl_advect_epilogue, epilogue_consts
from ..ops.stencils import stamp_temperature_bc
from ..physics.advection import advect_diffuse_step
from .stepper import TimeStepper

# 4-component radioactive-decay constants (prepare_gaia_ini.py:81-92).
DECAY_LAMBDAS = (14.200767386369366, 90.1668042856123,
                 4.534102158362219, 50.78194417365685)
DECAY_COEFFS = (0.130448695228009, 0.2345333106414419,
                0.07981198571490902, 0.55520600841564)


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
    """The ML_STOKES rollout (module docstring); runs where its stepper
    runs."""

    def __init__(self, stepper: TimeStepper, radioactive_decay: bool = False):
        self.stepper = stepper
        self.grid, self.params = stepper.grid, stepper.params
        self.radioactive_decay = radioactive_decay
        self.device, self.dtype = stepper.device, stepper.dtype
        # the fused epilogue applies when the stepper's surrogate is the
        # fused executor (stokes_psi gates B = 1 per step)
        m = getattr(stepper.apply_fn, "m", None)
        self._epi = None
        if hasattr(stepper.apply_fn, "apply_psi_from_T"):
            self._epi = epilogue_consts(stepper._metrics, m.a_bound,
                                        stepper.cn_max)
        self._raq = torch.full((), self.params.raq, dtype=self.dtype,
                               device=self.device)

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

    def _source(self, state: SimState):
        if not self.radioactive_decay:
            return self._raq
        return decay_heating(self.params.raq, state.t, True)

    @torch.no_grad()
    def step(self, state: SimState) -> SimState:
        """One coupled ML_STOKES step."""
        T = state.T
        sp = self.stepper.stokes_psi(T) if self._epi is not None else None
        if sp is not None:
            psi, V, s = sp
            u, v, T_new, dt = curl_advect_epilogue(
                psi[0], T[0], self._epi, s, self._source(state))
            return SimState(
                T=T_new[None], u=u[None], v=v[None], p=state.p, V=V,
                t=state.t + dt, dt=dt, n_step=state.n_step + 1,
                T_core=state.T_core)
        u, v, p, V = self.stepper.stokes(T)
        if p is None:
            p = state.p
        T_new, dt = advect_diffuse_step(u, v, T, self._source(state),
                                        self.stepper._metrics,
                                        cn_max=self.stepper.cn_max)
        T_new = torch.clamp(stamp_temperature_bc(T_new), 0.0, 2.0)
        return SimState(T=T_new, u=u, v=v, p=p, V=V, t=state.t + dt, dt=dt,
                        n_step=state.n_step + 1, T_core=state.T_core)

    @torch.no_grad()
    def multi_step(self, state: SimState, n_steps: int):
        """n_steps coupled steps queued without a host round trip;
        returns the final state and the per-step scalar trace (stacked
        device tensors)."""
        mean_T, ts, dts = [], [], []
        for _ in range(n_steps):
            state = self.step(state)
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
