"""Explicit upwind advection–diffusion temperature step ("ADNet").

Counterpart of the JAX package's ``physics/advection.py`` (reference:
pytorch_networks_convae.py:478-568): metric-aware first-order upwind
advection + conservative Laplacian diffusion + internal-heating source,
adaptive CFL/diffusive time step, explicit Euler update, replicate
padding and Dirichlet top/bottom rows. The adaptive dt stays a device
tensor: nothing here reads a value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..ops.stencils import dx_left, dx_right, dy_bot, dy_top, replicate_pad


class GridMetrics(NamedTuple):
    """Interior one-sided metric terms, each (H-2, W-2)
    (reference: pytorch_networks_convae.py:537-540)."""

    dx_l: torch.Tensor
    dx_r: torch.Tensor
    dy_t: torch.Tensor
    dy_b: torch.Tensor

    @property
    def dx_min(self):
        return torch.min(self.dx_l)


def grid_metrics(xc, yc, aspect: float = 4.0) -> GridMetrics:
    """Metric terms from (H, W) coordinate tensors, with the reference's
    boundary clamping (pytorch_networks_convae.py:532-540)."""
    xc = xc.clone()
    yc = yc.clone()
    xc[..., :, 0] = 0.0
    xc[..., :, -1] = aspect
    yc[..., 0, :] = 0.0
    yc[..., -1, :] = 1.0
    return GridMetrics(
        dx_l=dx_left(xc)[..., 1:-1, :].contiguous(),
        dx_r=dx_right(xc)[..., 1:-1, :].contiguous(),
        dy_t=dy_top(yc)[..., :, 1:-1].contiguous(),
        dy_b=dy_bot(yc)[..., :, 1:-1].contiguous(),
    )


def stability_dt(u_int, v_int, dx_min, cn_max: float = 0.1):
    """dt = min(advective CFL, explicit diffusive limit)
    (reference: pytorch_networks_convae.py:554-559)."""
    uv_mag = torch.maximum(u_int.abs().max(), v_int.abs().max())
    dt_advect = 0.5 * cn_max * dx_min / uv_mag
    dt_diffuse = 0.5 * (dx_min * dx_min) ** 2 / (dx_min**2 + dx_min**2)
    return torch.minimum(dt_advect, dt_diffuse)


def advect_diffuse_step(u, v, T, raq_ra, metrics: GridMetrics,
                        dt: Optional[torch.Tensor] = None,
                        cn_max: float = 0.1, bottom_T: float = 1.0,
                        top_T: float = 0.0, core_cool: bool = False):
    """One explicit upwind advection–diffusion Euler step.

    u, v, T: (..., H, W); raq_ra: scalar or (..., H-2, W-2) source. With
    ``core_cool`` the bottom row is left free: it replicates row 1
    (advect_wi_gaia.py:624-625). Returns (T_new, dt) with T_new
    (..., H, W) and dt a 0-d tensor (reference:
    pytorch_networks_convae.py:522-568).
    """
    u_int = u[..., 1:-1, 1:-1]
    v_int = v[..., 1:-1, 1:-1]

    gx_l = dx_left(T)[..., 1:-1, :] / metrics.dx_l
    gx_r = dx_right(T)[..., 1:-1, :] / metrics.dx_r
    gy_t = dy_top(T)[..., :, 1:-1] / metrics.dy_t
    gy_b = dy_bot(T)[..., :, 1:-1] / metrics.dy_b

    dT_dx = gx_l * (u_int > 0) + gx_r * (u_int < 0)
    dT_dy = gy_t * (v_int > 0) + gy_b * (v_int < 0)
    T_laplace = ((gx_r - gx_l) / (0.5 * metrics.dx_r + 0.5 * metrics.dx_l)
                 + (gy_b - gy_t) / (0.5 * metrics.dy_b + 0.5 * metrics.dy_t))

    if dt is None:
        dt = stability_dt(u_int, v_int, metrics.dx_min, cn_max)

    T_int = T[..., 1:-1, 1:-1] + dt * (
        -u_int * dT_dx - v_int * dT_dy + T_laplace + raq_ra)
    T_new = replicate_pad(T_int)
    if not core_cool:
        T_new[..., 0, :] = bottom_T
    T_new[..., -1, :] = top_T
    return T_new, dt


def viscous_dissipation(u, v, V, metrics: GridMetrics):
    """EBA viscous-dissipation density Φ = 2η ε̇:ε̇
    = η [2(∂u/∂x)² + 2(∂v/∂y)² + (∂u/∂y + ∂v/∂x)²] on the interior,
    (..., H-2, W-2), from (..., H, W) velocities and viscosity. Centred
    differences over the one-sided metric pairs. The energy equation
    gains +(Di/Ra)·Φ under GAIA's MCEnergy=Boussinesq/Compress
    (prepare_gaia_ini.py:61-62), with Ra = 1 (prepare_gaia_ini.py:117)."""
    dx_c = metrics.dx_l + metrics.dx_r    # x[c+1] - x[c-1]
    dy_c = metrics.dy_t + metrics.dy_b    # y[r+1] - y[r-1]
    du_dx = (u[..., 1:-1, 2:] - u[..., 1:-1, :-2]) / dx_c
    dv_dx = (v[..., 1:-1, 2:] - v[..., 1:-1, :-2]) / dx_c
    du_dy = (u[..., 2:, 1:-1] - u[..., :-2, 1:-1]) / dy_c
    dv_dy = (v[..., 2:, 1:-1] - v[..., :-2, 1:-1]) / dy_c
    shear = du_dy + dv_dx
    return V[..., 1:-1, 1:-1] * (
        2.0 * du_dx**2 + 2.0 * dv_dy**2 + shear**2)
