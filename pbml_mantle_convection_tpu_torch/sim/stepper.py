"""TimeStepper: the coupled surrogate Stokes solve + energy step.

Counterpart of the fluidnet and U-Net branches of the JAX package's
``sim/stepper.py`` (reference ``TS``, pytorch_networks_convae.py:266-475):
per step the FK viscosity from the current temperature, the 7-channel
surrogate input, the Stokes surrogate, velocity unscaling and the
explicit advection–diffusion update with BC stamping. The energy update
is ``ops/advect_kernel.py::advect_diffuse_step_fused``: the CUDA kernel
on the card, its plain version on the CPU. A stepper without a surrogate
(``apply_fn=None``) serves the engine's ``mode="GAIA"``. With
``net="unet"`` (or ``"iunet"``) the network predicts the new temperature
itself (:meth:`TimeStepper.step_unet`, dt from :meth:`TimeStepper.
unet_dt`): no energy step runs. The legacy iterative ``ifluidnet`` branch
(:meth:`TimeStepper.stokes_iterative`, :meth:`TimeStepper.step_iterative`)
feeds the velocity iterate back as input channels.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch

from ..constants import COORD_SCALE, SimParams, velocity_scaler, visc_feature
from ..models.fast_path import FastNewFluidNet
from ..models.fluidnet import HALF_HEAD
from ..ops.advect_kernel import advect_diffuse_step_fused
from ..ops.stencils import stamp_temperature_bc
from ..physics.advection import grid_metrics
from ..physics.viscosity import fk_viscosity, fk_viscosity_clipped
from ..utils.profiling import span
from .grid import Grid


_TRANSOLVER = ("a Transolver reads (B, N, C) points and the stepper hands "
               "its surrogate an NHWC image: JAX's stepper fails in the "
               "Transolver's own input concat (a TypeError)")
# networks with no coupled rollout, in the port as in JAX, and why
NO_ROLLOUT = {
    "halfnewfluidnet": HALF_HEAD,
    "transolver_structured": _TRANSOLVER,
    "transolver": _TRANSOLVER,
    "convae": ("the ConvAE has no coupled rollout: it predicts no "
               "temperature, and the stepper has no branch for it (nor has "
               "the JAX stepper)"),
}


class StaticFields(NamedTuple):
    """Per-grid constant planes, (H, W) each."""

    xc_feat: torch.Tensor   # xc / 4
    yc_feat: torch.Tensor   # yc / 4
    raq_nd: torch.Tensor
    fkt_nd: torch.Tensor
    fkp_nd: torch.Tensor
    depth: torch.Tensor     # 1 - yc, the FK viscosity's depth


def make_static_fields(grid: Grid, params: SimParams, dtype=torch.float32,
                       device=None) -> StaticFields:
    xc, yc = grid.coords(device or "cuda", dtype)

    def full(v):
        return torch.full_like(xc, v)

    yc_feat = yc / COORD_SCALE
    return StaticFields(xc / COORD_SCALE, yc_feat, full(params.raq_nd),
                        full(params.fkt_nd), full(params.fkp_nd),
                        1.0 - yc_feat * COORD_SCALE)


def viscosity(T, static: StaticFields, params: SimParams):
    """Clipped FK viscosity of a (B, H, W) temperature."""
    return fk_viscosity_clipped(params.fkt, params.fkp, static.depth, T)


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


def assemble_unet_input(T, u_prev, v_prev, dt, static: StaticFields,
                        params: SimParams, p_prev=None):
    """10/11-channel NHWC U-Net input (xc/4, yc/4, dt, raq_nd, fkt_nd,
    fkp_nd, log10(V)/8, T, u_prev, v_prev[, p_prev]) of (B, H, W) fields
    → ((B, H, W, C), V), V the unclipped FK viscosity (reference:
    pytorch_networks_convae.py:419-441, datasetio.py:258-274)."""
    V = fk_viscosity(params.fkt, params.fkp, static.depth, T)
    b = T.shape[0]

    def bcast(p):
        return p.expand((b,) + tuple(p.shape))

    chans = [bcast(static.xc_feat), bcast(static.yc_feat),
             torch.as_tensor(dt, dtype=T.dtype, device=T.device)
             .expand(T.shape),
             bcast(static.raq_nd), bcast(static.fkt_nd),
             bcast(static.fkp_nd), visc_feature(V), T, u_prev, v_prev]
    if p_prev is not None:
        chans.append(p_prev)
    return torch.stack(chans, dim=-1), V


def assemble_ifluidnet_input(T, u, v, grid: Grid, static: StaticFields,
                             params: SimParams):
    """9-channel NHWC input (sdf, sdf2, log10(V)/8, raq_nd, fkt_nd,
    fkp_nd, T, u, v) of the legacy iterative-fluidnet branch: the boundary
    rings replace the coordinate channels and the running velocity
    iterate is fed back (reference: pycold-checkpoint.py:326-341). T, u,
    v: (B, H, W). Returns ((B, H, W, 9), the clipped viscosity)."""
    V = viscosity(T, static, params)
    b = T.shape[0]

    def bcast(p):
        return p.expand((b,) + tuple(p.shape))

    def ring(m):
        return bcast(torch.as_tensor(m, dtype=T.dtype, device=T.device))

    x = torch.stack(
        [ring(grid.sdf), ring(grid.sdf2), visc_feature(V),
         bcast(static.raq_nd), bcast(static.fkt_nd), bcast(static.fkp_nd),
         T, u, v], dim=-1)
    return x, V


def _zero_corners(f):
    """A copy of a (B, H, W) field with its four corner cells zeroed
    (pycold-checkpoint.py:384-399)."""
    f = f.clone()
    for r in (0, -1):
        for c in (0, -1):
            f[..., r, c] = 0.0
    return f


def _edge_pad_w(x, n: int):
    """Replicate-pad the W axis (dim 2) of an NHWC tensor by ``n`` each
    side."""
    w = x.shape[2]
    return torch.cat([x[:, :, :1].expand(-1, -1, n, -1), x,
                      x[:, :, w - 1:].expand(-1, -1, n, -1)], dim=2)


class TimeStepper:
    """Coupled Stokes-surrogate + advection step (the reference ``TS``),
    forward only (no autograd graph is kept).

    ``apply_fn``: (B, H, W, 7) NHWC → (u, v, p|None), e.g. a
    :class:`~..models.fluidnet.NewFluidNet`; a
    :class:`~..models.fast_path.FastNewFluidNet` (``executor``) takes the
    planar input of one simulation (:meth:`executor_input`; B calls per
    step) and also serves the engine's fused path (:meth:`stokes_psi`);
    None for a stepper without a surrogate.
    ``net`` "unet" or "iunet": ``apply_fn`` maps the U-Net input to
    (u, v, p|None, T) (:meth:`step_unet`), with the previous pressure as
    its 11th channel when ``unet_p_pred``. ``core_cool`` leaves the
    bottom row of :meth:`step` free.

    ``static``, ``metrics`` and ``heating`` (the constant internal
    heating RaQ, a 0-d tensor) are the grid's and the parameters'
    constants the engine's energy step reads too.
    """

    def __init__(self, grid: Grid, params: SimParams,
                 apply_fn: Optional[Callable[..., Any]],
                 cn_max: float = 0.99, core_cool: bool = False,
                 dtype=torch.float32, device=None,
                 net: str = "newfluidnet", unet_p_pred: bool = False):
        self.grid, self.params, self.apply_fn = grid, params, apply_fn
        self.net, self.unet_p_pred = net, unet_p_pred
        self.cn_max, self.core_cool, self.dtype = cn_max, core_cool, dtype
        self.device = torch.device(device or "cuda")
        self.static = make_static_fields(grid, params, dtype, self.device)
        self.metrics = grid_metrics(*grid.coords(self.device, dtype),
                                    aspect=grid.aspect)
        self.heating = torch.full((), params.raq, dtype=dtype,
                                  device=self.device)
        self.scaler = float(velocity_scaler(params.raq, params.fkt,
                                            params.fkp))
        # the fused executor, and its planar input with the viscosity
        # and temperature channels left zero: the five other channels
        # are constants of the (grid, params) pair
        self.executor = self.template = None
        if isinstance(apply_fn, FastNewFluidNet):
            st, z = self.static, torch.zeros_like(self.static.xc_feat)
            self.executor = apply_fn
            self.template = torch.stack(
                [st.xc_feat, st.yc_feat, z, st.raq_nd, st.fkt_nd,
                 st.fkp_nd, z]).contiguous()

    def executor_input(self, T, V):
        """(1, H, W) temperature and its clipped viscosity → the
        executor's (7, H, W) planar input, the channels of
        :func:`assemble_fluidnet_input`."""
        with span("pmc.engine.input"):
            x = self.template.clone()
            x[2] = visc_feature(V[0])
            x[6] = T[0]
            return x

    @torch.no_grad()
    def stokes(self, T):
        """Surrogate Stokes solve: (B, H, W) T → (u, v, p, V), velocities
        in physical (unscaled) units (pytorch_networks_convae.py:377-417)."""
        if self.apply_fn is None:
            raise ValueError("TimeStepper.stokes: this stepper has no "
                             "surrogate (apply_fn=None)")
        fn = self.executor
        if fn is not None:
            with span("pmc.engine.input"):
                V = viscosity(T, self.static, self.params)
            # each simulation through the B = 1 executor in turn, as the
            # JAX stepper's lax.map does (stepper.py:212-228), each one's
            # p stacked with ``p_pred``
            outs = [fn.m.head(fn.psi(self.executor_input(
                        T[i:i + 1], V[i:i + 1]))[None])
                    for i in range(T.shape[0])]
            u, v, p = outs[0] if len(outs) == 1 else (
                torch.cat(f) if f[0] is not None else None
                for f in zip(*outs))
        else:
            x, V = assemble_fluidnet_input(T, self.static, self.params)
            u, v, p = self.apply_fn(x)
        return u * self.scaler, v * self.scaler, p, V

    @torch.no_grad()
    def stokes_psi(self, T):
        """(psi, V) of a (1, H, W) temperature through the executor:
        merge 3's raw (c_o, H, W) output, whose channel 0 is the stream
        function the engine's fused epilogue takes, and the clipped
        viscosity."""
        with span("pmc.engine.input"):
            V = viscosity(T, self.static, self.params)
        return self.executor.psi(self.executor_input(T, V)), V

    @torch.no_grad()
    def step(self, T, dt=None):
        """Stokes surrogate then the explicit energy update with BC
        stamping; returns (T_new, dt, u, v, p, V)."""
        u, v, p, V = self.stokes(T)
        T_new, dt = advect_diffuse_step_fused(
            u, v, T, self.heating, self.metrics, dt=dt, cn_max=self.cn_max,
            core_cool=self.core_cool)
        return (stamp_temperature_bc(T_new, core_cool=self.core_cool), dt,
                u, v, p, V)

    @torch.no_grad()
    def stokes_iterative(self, T, n_iter: int = 1):
        """The legacy ``ifluidnet`` Stokes solve (pycold-checkpoint.py:
        322-343): the surrogate takes the previous velocity iterate as
        input channels 8-9 (zeros on the first pass) and is applied
        ``n_iter`` times, its input replicate-padded by 3 in W and its
        outputs cropped back; then the velocities are unscaled and the
        corners of every output zeroed (:363-399). Returns (u, v, p, V),
        u and v in physical units."""
        u, v = torch.zeros_like(T), torch.zeros_like(T)
        p = V = None
        for _ in range(n_iter):
            x, V = assemble_ifluidnet_input(T, u, v, self.grid,
                                            self.static, self.params)
            u, v, p = self.apply_fn(_edge_pad_w(x, 3))
            u, v = u[..., 3:-3], v[..., 3:-3]
            if p is not None:
                p = p[..., 3:-3]
        u = _zero_corners(u * self.scaler)
        v = _zero_corners(v * self.scaler)
        if p is not None:
            p = _zero_corners(p)
        return u, v, p, V

    @torch.no_grad()
    def step_iterative(self, T, dt=None, n_iter: int = 1):
        """One coupled legacy step: :meth:`stokes_iterative`, then the
        explicit energy update with BC stamping (pycold-checkpoint.py:
        401-414); returns (T_new, dt, u, v, p, V) like :meth:`step`."""
        u, v, p, V = self.stokes_iterative(T, n_iter=n_iter)
        T_new, dt = advect_diffuse_step_fused(
            u, v, T, self.heating, self.metrics, dt=dt, cn_max=self.cn_max,
            core_cool=self.core_cool)
        return (stamp_temperature_bc(T_new, core_cool=self.core_cool), dt,
                u, v, p, V)

    def unet_dt(self, u_prev, v_prev, cn_max: float = 100.0):
        """The U-Net rollout's driver-level CFL dt
        (advect_wi_gaia.py:739-747) from *scaled* velocities: a 0-d
        tensor."""
        s = self.scaler
        dx_min = 0.5 * self.grid.dy
        uv = torch.maximum((u_prev * s).abs().max(), (v_prev * s).abs().max())
        dt_advect = 0.5 * cn_max * dx_min / uv
        dt_diffuse = 0.5 * (dx_min * dx_min) ** 2 / (2.0 * dx_min ** 2)
        return torch.clamp(dt_advect, max=dt_diffuse)

    @torch.no_grad()
    def step_unet(self, T, u_prev, v_prev, dt, p_prev=None):
        """One coupled U-Net step: the network predicts the stream
        function and the new temperature (pytorch_networks_convae.py:
        419-451, advect_wi_gaia.py:734-797); ``u_prev``, ``v_prev``
        scaled. Returns (T_new, u, v, p, V), u and v unscaled."""
        x, V = assemble_unet_input(T, u_prev, v_prev, dt, self.static,
                                   self.params, p_prev=p_prev)
        u, v, p, T_new = self.apply_fn(x)
        T_new = stamp_temperature_bc(T_new, core_cool=self.core_cool)
        T_new = torch.clamp(T_new, 0.0, 2.0)
        return T_new, u * self.scaler, v * self.scaler, p, V
