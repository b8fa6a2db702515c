"""TimeStepper: the coupled surrogate Stokes solve + energy step.

Counterpart of the fluidnet branch of the JAX package's ``sim/stepper.py``
(reference ``TS``, pytorch_networks_convae.py:266-475): per step the FK
viscosity from the current temperature, the 7-channel surrogate input,
the Stokes surrogate, velocity unscaling and the explicit
advection–diffusion update with BC stamping. The energy update is
``ops/advect_kernel.py::advect_diffuse_step_fused``: the CUDA kernel on
the card, its plain version on the CPU. A stepper without a surrogate
(``apply_fn=None``) serves the engine's ``mode="GAIA"``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from ..constants import COORD_SCALE, SimParams, velocity_scaler, visc_feature
from ..ops.advect_kernel import advect_diffuse_step_fused
from ..ops.stencils import stamp_temperature_bc
from ..physics.advection import grid_metrics
from ..physics.viscosity import fk_viscosity_clipped
from .grid import Grid


class StaticFields(NamedTuple):
    """Per-grid constant feature planes, (H, W) each."""

    xc_feat: torch.Tensor   # xc / 4
    yc_feat: torch.Tensor   # yc / 4
    raq_nd: torch.Tensor
    fkt_nd: torch.Tensor
    fkp_nd: torch.Tensor


def make_static_fields(grid: Grid, params: SimParams, dtype=torch.float32,
                       device=None) -> StaticFields:
    xc, yc = grid.coords(device or "cuda", dtype)

    def full(v):
        return torch.full_like(xc, v)

    return StaticFields(xc / COORD_SCALE, yc / COORD_SCALE,
                        full(params.raq_nd), full(params.fkt_nd),
                        full(params.fkp_nd))


def viscosity(T, static: StaticFields, params: SimParams):
    """Clipped FK viscosity of a (B, H, W) temperature."""
    return fk_viscosity_clipped(params.fkt, params.fkp,
                                1.0 - static.yc_feat * COORD_SCALE, T)


def assemble_fluidnet_input(T, static: StaticFields, params: SimParams):
    """7-channel NHWC input (xc/4, yc/4, log10(V)/8, raq_nd, fkt_nd,
    fkp_nd, T) of a (B, H, W) temperature → ((B, H, W, 7), V)
    (reference: pytorch_networks_convae.py:388-407)."""
    V = viscosity(T, static, params)
    b = T.shape[0]

    def bcast(p):
        return p.expand((b,) + tuple(p.shape))

    x = torch.stack(
        [bcast(static.xc_feat), bcast(static.yc_feat), visc_feature(V),
         bcast(static.raq_nd), bcast(static.fkt_nd), bcast(static.fkp_nd),
         T], dim=-1)
    return x, V


class TimeStepper:
    """Coupled Stokes-surrogate + advection step (the reference ``TS``),
    forward only (no autograd graph is kept).

    ``apply_fn``: (B, H, W, 7) NHWC → (u, v, p|None), e.g. a
    :class:`~..models.fluidnet.NewFluidNet`; a
    :class:`~..models.fast_path.FastNewFluidNet` also serves the fused
    path (:meth:`stokes_psi`); None for a stepper without a surrogate.
    ``core_cool`` leaves the bottom row of :meth:`step` free.
    """

    def __init__(self, grid: Grid, params: SimParams,
                 apply_fn: Optional[Callable[..., Any]],
                 cn_max: float = 0.99, core_cool: bool = False,
                 dtype=torch.float32, device=None):
        self.grid, self.params, self.apply_fn = grid, params, apply_fn
        self.cn_max, self.core_cool, self.dtype = cn_max, core_cool, dtype
        self.device = torch.device(device or "cuda")
        self._static = make_static_fields(grid, params, dtype, self.device)
        self._metrics = grid_metrics(*grid.coords(self.device, dtype),
                                     aspect=grid.aspect)
        self._raq = torch.full((), params.raq, dtype=dtype,
                               device=self.device)
        self.scaler = float(velocity_scaler(params.raq, params.fkt,
                                            params.fkp))

    def _bound_fast(self):
        """The fused executor with this stepper's input channels bound,
        or None when ``apply_fn`` is not one."""
        fn = self.apply_fn
        if not hasattr(fn, "bind_input_assembly"):
            return None
        if (fn._in_static is not self._static
                or fn._in_params is not self.params):
            fn.bind_input_assembly(self._static, self.params)
        return fn

    @torch.no_grad()
    def stokes(self, T):
        """Surrogate Stokes solve: (B, H, W) T → (u, v, p, V), velocities
        in physical (unscaled) units (pytorch_networks_convae.py:377-417)."""
        if self.apply_fn is None:
            raise ValueError("TimeStepper.stokes: this stepper has no "
                             "surrogate (apply_fn=None)")
        fn = self._bound_fast()
        if fn is not None and T.shape[0] == 1:
            V = viscosity(T, self._static, self.params)
            u, v, p = fn.apply_from_T(T, V)
        else:
            x, V = assemble_fluidnet_input(T, self._static, self.params)
            u, v, p = self.apply_fn(x)
        return u * self.scaler, v * self.scaler, p, V

    @torch.no_grad()
    def stokes_psi(self, T):
        """(psi, V, scaler) for the fused curl + advection epilogue when
        ``apply_fn`` is the fused executor and B = 1; None otherwise."""
        fn = self._bound_fast()
        if fn is None or T.shape[0] != 1:
            return None
        V = viscosity(T, self._static, self.params)
        return fn.apply_psi_from_T(T, V), V, self.scaler

    @torch.no_grad()
    def step(self, T, dt=None):
        """Stokes surrogate then the explicit energy update with BC
        stamping; returns (T_new, dt, u, v, p, V)."""
        u, v, p, V = self.stokes(T)
        T_new, dt = advect_diffuse_step_fused(
            u, v, T, self._raq, self._metrics, dt=dt, cn_max=self.cn_max,
            core_cool=self.core_cool)
        return (stamp_temperature_bc(T_new, core_cool=self.core_cool), dt,
                u, v, p, V)
