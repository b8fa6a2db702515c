"""Plain reference of the simulation's physics: the grid, the
Frank-Kamenetskii viscosity, the 7-channel surrogate input, the curl
head, the upwind energy step with its adaptive dt, the temperature BCs
and the pseudo-transient (PT) Stokes solve.

Written from the published equations of the reference code
(pytorch_networks_convae.py, advect_wi_gaia.py, datasetio.py, scaler.py)
as plain PyTorch in any float type; it imports nothing of the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# scaler.py:4-36 and datasetio.py:124-136
SCALER = (1.80167667, 0.4330392, -0.46052953, 5.0)
RAQ_RANGE = (0.12624371, 9.70723344)
LOG10_FKT_RANGE = (6.00352841978384, 9.888820429862925)
LOG10_FKP_RANGE = (0.005251646002323797, 1.9927988938926755)


def velocity_scaler(raq, fkt, fkp) -> float:
    a, b, c, pre = SCALER
    return float(math.exp((raq / 10.0) * a + math.log(fkt) * b
                          + math.log(fkp) * c) * pre)


def nondim(raq, fkt, fkp):
    """(raq, fkt, fkp) → their [0, 1] input-channel values."""
    return ((raq - RAQ_RANGE[0]) / (RAQ_RANGE[1] - RAQ_RANGE[0]),
            (math.log10(fkt) - LOG10_FKT_RANGE[0])
            / (LOG10_FKT_RANGE[1] - LOG10_FKT_RANGE[0]),
            (math.log10(fkp) - LOG10_FKP_RANGE[0])
            / (LOG10_FKP_RANGE[1] - LOG10_FKP_RANGE[0]))


def grid_coords(H: int, W: int, aspect: float):
    """(xc, yc) float64 numpy (H, W): cell centres, boundary rows and
    columns on the walls (prepare_gaia_ini.py:23-26)."""
    def centres(n, length):
        c = (np.arange(n, dtype=np.float64) - 0.5) * (length / (n - 2))
        c[0], c[-1] = 0.0, length
        return c

    x, y = centres(W, aspect), centres(H, 1.0)
    return (np.broadcast_to(x[None, :], (H, W)).copy(),
            np.broadcast_to(y[:, None], (H, W)).copy())


def fk_viscosity(fkt, fkp, depth, T, clip=True):
    """exp(-ln(fkt)·T + ln(fkp)·depth), clipped to [1e-8, 1] for the
    surrogate (pytorch_networks_convae.py:86-102, 389)."""
    V = torch.exp(-math.log(fkt) * T + math.log(fkp) * depth)
    return torch.clamp(V, 1e-8, 1.0) if clip else V


def visc_feature(V):
    return torch.log10(torch.clamp(V, 1e-8, 1.0)) / 8.0


def fluidnet_input(T, xc, yc, raq, fkt, fkp):
    """(B, H, W) T → ((B, H, W, 7) input, clipped V): xc/4, yc/4,
    log10(V)/8, raq, fkt, fkp (non-dimensional), T (datasetio.py:630-641)."""
    V = fk_viscosity(fkt, fkp, 1.0 - yc, T)
    r, ft, fp = nondim(raq, fkt, fkp)
    ones = torch.ones_like(T)
    x = torch.stack([ones * (xc / 4.0), ones * (yc / 4.0), visc_feature(V),
                     ones * r, ones * ft, ones * fp, T], dim=-1)
    return x, V


# -- stencils ----------------------------------------------------------
def replicate_pad(x, pad=(1, 1, 1, 1)):
    lead = x.shape[:-2]
    y = F.pad(x.reshape((-1, 1) + tuple(x.shape[-2:])), pad,
              mode="replicate")
    return y.reshape(lead + tuple(y.shape[-2:]))


def curl_padded(a):
    """u = ∂a/∂y, v = -∂a/∂x (central, VALID), replicate-padded back to
    (H, W) with antisymmetric sidewalls and zero corners
    (pytorch_networks_convae.py:1369-1386)."""
    dy = 0.5 * (a[..., 2:, :] - a[..., :-2, :])
    dx = 0.5 * (a[..., :, 2:] - a[..., :, :-2])
    u = replicate_pad(dy[..., :, 1:-1])
    u[..., :, 0] = -u[..., :, 1]
    u[..., :, -1] = -u[..., :, -2]
    v = replicate_pad(-dx[..., 1:-1, :])
    v[..., 0, :] = -v[..., 1, :]
    v[..., -1, :] = -v[..., -2, :]
    for f in (u, v):
        f[..., 0, 0] = f[..., 0, -1] = f[..., -1, 0] = f[..., -1, -1] = 0.0
    return u, v


def curl_valid(a):
    """u = ∂a/∂y, v = -∂a/∂x on the (H-2, W-2) interior."""
    return (0.5 * (a[..., 2:, 1:-1] - a[..., :-2, 1:-1]),
            -0.5 * (a[..., 1:-1, 2:] - a[..., 1:-1, :-2]))


# -- the energy step ---------------------------------------------------
def metrics(xc, yc, aspect):
    """One-sided spacings of the interior (H-2, W-2), walls clamped
    (pytorch_networks_convae.py:532-540)."""
    xc, yc = xc.clone(), yc.clone()
    xc[:, 0], xc[:, -1] = 0.0, aspect
    yc[0, :], yc[-1, :] = 0.0, 1.0
    return {"dx_l": (xc[:, 1:-1] - xc[:, :-2])[1:-1],
            "dx_r": (xc[:, 2:] - xc[:, 1:-1])[1:-1],
            "dy_t": (yc[1:-1] - yc[:-2])[:, 1:-1],
            "dy_b": (yc[2:] - yc[1:-1])[:, 1:-1]}


def energy_step(u, v, T, src, m, cn_max):
    """One explicit upwind advection-diffusion step with the adaptive
    dt = min(0.5·cn·dx/max|u, v|, 0.5·dx⁴/(2dx²)); replicate-padded,
    T = 1 below and 0 above, then clipped to [0, 2]
    (pytorch_networks_convae.py:522-568, 465-471). Returns (T, dt)."""
    ui, vi = u[..., 1:-1, 1:-1], v[..., 1:-1, 1:-1]
    gx_l = (T[..., 1:-1, 1:-1] - T[..., 1:-1, :-2]) / m["dx_l"]
    gx_r = (T[..., 1:-1, 2:] - T[..., 1:-1, 1:-1]) / m["dx_r"]
    gy_t = (T[..., 1:-1, 1:-1] - T[..., :-2, 1:-1]) / m["dy_t"]
    gy_b = (T[..., 2:, 1:-1] - T[..., 1:-1, 1:-1]) / m["dy_b"]
    dT_dx = gx_l * (ui > 0) + gx_r * (ui < 0)
    dT_dy = gy_t * (vi > 0) + gy_b * (vi < 0)
    lap = ((gx_r - gx_l) / (0.5 * m["dx_r"] + 0.5 * m["dx_l"])
           + (gy_b - gy_t) / (0.5 * m["dy_b"] + 0.5 * m["dy_t"]))
    dx = m["dx_l"].min()
    dt = torch.minimum(
        0.5 * cn_max * dx / torch.maximum(ui.abs().max(), vi.abs().max()),
        0.5 * (dx * dx) ** 2 / (2.0 * dx * dx))
    Ti = T[..., 1:-1, 1:-1] + dt * (-ui * dT_dx - vi * dT_dy + lap + src)
    T_new = replicate_pad(Ti)
    T_new[..., 0, :] = 1.0
    T_new[..., -1, :] = 0.0
    T_new[..., :, 0] = T_new[..., :, 1]
    T_new[..., :, -1] = T_new[..., :, -2]
    return torch.clamp(T_new, 0.0, 2.0), dt


# -- the PT Stokes solve -----------------------------------------------
def pt_stokes(T, V, u0, v0, p0, raq, dy, dx, n_iter, vdamp=8.0, vsc=0.8,
              ptsc=2.0):
    """``n_iter`` accelerated pseudo-transient iterations of the
    variable-viscosity Stokes system ∇·(2ηε̇) − ∇p + RaQ·T ŷ = 0, ∇·u = 0
    on the staggered interior, free-slip walls, warm-started from the
    cell-centred (H, W) fields u0, v0, p0. T, V: (..., H, W). Returns the
    cell-centred (u, v, p) on the full grid with the walls stamped."""
    T_c, eta = T[..., 1:-1, 1:-1], V[..., 1:-1, 1:-1]
    ny, nx = T_c.shape[-2:]
    lead = T_c.shape[:-2]
    z = T_c.new_zeros
    u, v = z(lead + (ny, nx + 1)), z(lead + (ny + 1, nx))
    u0, v0 = u0[..., 1:-1, 1:-1], v0[..., 1:-1, 1:-1]
    u[..., :, 1:-1] = 0.5 * (u0[..., :, 1:] + u0[..., :, :-1])
    v[..., 1:-1, :] = 0.5 * (v0[..., 1:, :] + v0[..., :-1, :])
    p = p0[..., 1:-1, 1:-1].clone()
    dudt, dvdt = z(lead + (ny, nx - 1)), z(lead + (ny - 1, nx))
    two_eta_c = 2.0 * eta
    le = torch.log(replicate_pad(eta))
    two_eta_n = 2.0 * torch.exp(0.25 * (le[..., :-1, :-1] + le[..., :-1, 1:]
                                        + le[..., 1:, :-1] + le[..., 1:, 1:]))
    Tp = torch.cat([T_c[..., :1, :], T_c, T_c[..., -1:, :]], dim=-2)
    fy = (raq * 0.5 * (Tp[..., :-1, :] + Tp[..., 1:, :]))[..., 1:-1, :]
    dtau = vsc * min(dx, dy) ** 2 / 4.1
    damp = 1.0 - vdamp / max(ny, nx)
    step_u = dtau / torch.maximum(eta[..., :, 1:], eta[..., :, :-1])
    step_v = dtau / torch.maximum(eta[..., 1:, :], eta[..., :-1, :])
    dtau_p = ptsc * 4.1 * eta / max(nx, ny)
    for _ in range(n_iter):
        exx = (u[..., :, 1:] - u[..., :, :-1]) / dx
        eyy = (v[..., 1:, :] - v[..., :-1, :]) / dy
        du = F.pad(u[..., 1:, :] - u[..., :-1, :], (0, 0, 1, 1))
        dv = F.pad(v[..., :, 1:] - v[..., :, :-1], (1, 1, 0, 0))
        txy = two_eta_n * 0.5 * (du / dy + dv / dx)
        txx, tyy = two_eta_c * exx - p, two_eta_c * eyy - p
        Ru = ((txx[..., :, 1:] - txx[..., :, :-1]) / dx
              + (txy[..., 1:, 1:-1] - txy[..., :-1, 1:-1]) / dy)
        Rv = ((tyy[..., 1:, :] - tyy[..., :-1, :]) / dy
              + (txy[..., 1:-1, 1:] - txy[..., 1:-1, :-1]) / dx + fy)
        dudt = damp * dudt + Ru
        dvdt = damp * dvdt + Rv
        u[..., :, 1:-1] += step_u * dudt
        v[..., 1:-1, :] += step_v * dvdt
        p = p - dtau_p * ((u[..., :, 1:] - u[..., :, :-1]) / dx
                          + (v[..., 1:, :] - v[..., :-1, :]) / dy)
    full = T.new_zeros(lead + (ny + 2, nx + 2))
    uf, vf, pf = full.clone(), full.clone(), full.clone()
    uf[..., 1:-1, 1:-1] = 0.5 * (u[..., :, 1:] + u[..., :, :-1])
    vf[..., 1:-1, 1:-1] = 0.5 * (v[..., 1:, :] + v[..., :-1, :])
    pf[..., 1:-1, 1:-1] = p - p.mean(dim=(-2, -1), keepdim=True)
    uf[..., 0, 1:-1], uf[..., -1, 1:-1] = uf[..., 1, 1:-1], uf[..., -2, 1:-1]
    vf[..., 1:-1, 0], vf[..., 1:-1, -1] = vf[..., 1:-1, 1], vf[..., 1:-1, -2]
    return uf, vf, pf
