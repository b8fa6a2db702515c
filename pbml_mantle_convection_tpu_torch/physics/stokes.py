"""Iterative variable-viscosity Stokes solver (the GAIA-mode stand-in).

Counterpart of the JAX package's ``physics/stokes.py``: an accelerated
pseudo-transient (PT) relaxation of the Boussinesq, infinite-Prandtl
Stokes system on a staggered grid,

    ∇·(2 η ε̇(u)) - ∇p + RaQ·T ŷ = 0,   ∇·u = 0,

with free-slip, impermeable walls (the reference's BCs: pad_uvp,
pytorch_networks_convae.py:145-178; GAIA config prepare_gaia_ini.py:116-126).
It serves ``mode="GAIA"``, the momentum-skip variant and ``mode="ML_PRE"``
of the engine. Plain PyTorch: no Pallas kernel stands behind it in JAX.

Fields carry any leading batch dimensions, so one call solves B
simulations; the operations and their order are those of the JAX solver.
With ``ptol > 0`` the residuals are checked every ``check_every``
iterations (one host read per check) and each simulation stops on its
own, as under ``jax.vmap``: a member that has converged is frozen while
the others go on.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..ops.stencils import replicate_pad


class StokesResult(NamedTuple):
    u: torch.Tensor        # (..., H, W) cell-centred x-velocity
    v: torch.Tensor        # (..., H, W) cell-centred y-velocity
    p: torch.Tensor        # (..., H, W) pressure
    err_mom: torch.Tensor  # (...) max |momentum residual| / max |buoyancy|
    err_div: torch.Tensor  # (...) max |div u| · h_min / max |velocity|
    n_done: torch.Tensor   # (...) PT iterations run (ptol early stop)


def _amax2(x):
    return x.abs().amax(dim=(-2, -1))


@dataclasses.dataclass(frozen=True)
class PTStokesSolver:
    """Accelerated PT Stokes solver on an (ny, nx) interior staggered grid
    (u on x-faces, v on y-faces, p at centres); the parameters are the
    JAX solver's."""

    ny: int                  # interior cells in y (H - 2)
    nx: int                  # interior cells in x (W - 2)
    dy: float
    dx: float
    raq: float = 1.0
    n_iter: int = 2000
    vdamp: float = 8.0       # velocity damping
    vsc: float = 0.8         # velocity pseudo-step safety factor
    ptsc: float = 2.0        # pressure pseudo-step safety factor
    # stop once max(err_mom, err_div) < ptol, checked every check_every
    # iterations; ptol = 0 runs exactly n_iter iterations
    ptol: float = 1e-5
    check_every: int = 250

    @staticmethod
    def _eta_nodes(eta_c):
        """Viscosity at cell corners: geometric mean of the 4 neighbouring
        centres (edge-padded), (..., ny+1, nx+1)."""
        log_e = torch.log(replicate_pad(eta_c))
        n = 0.25 * (log_e[..., :-1, :-1] + log_e[..., :-1, 1:]
                    + log_e[..., 1:, :-1] + log_e[..., 1:, 1:])
        return torch.exp(n)

    def solve(self, T_c, eta_c, u0=None, v0=None, p0=None,
              n_iter: Optional[int] = None) -> StokesResult:
        """T_c, eta_c: (..., ny, nx) cell-centred temperature and viscosity.

        ``u0``/``v0``/``p0`` (optional, cell-centred (..., ny, nx))
        warm-start the iteration (mode ML_PRE); ``n_iter`` overrides the
        configured count. Returns cell-centred fields embedded in the full
        (..., ny+2, nx+2) grid with the reference's BC stamping.
        """
        ny, nx, dy, dx = self.ny, self.nx, self.dy, self.dx
        lead = tuple(T_c.shape[:-2])

        def zeros(*shape):
            return T_c.new_zeros(lead + shape)

        # staggered unknowns; a warm start puts the mean of the adjacent
        # centres on the interior faces, the walls stay 0
        u, v, p = zeros(ny, nx + 1), zeros(ny + 1, nx), zeros(ny, nx)
        if u0 is not None:
            u[..., :, 1:-1] = 0.5 * (u0[..., :, 1:] + u0[..., :, :-1])
        if v0 is not None:
            v[..., 1:-1, :] = 0.5 * (v0[..., 1:, :] + v0[..., :-1, :])
        if p0 is not None:
            p = p0.to(T_c.dtype).clone()
        dudt, dvdt = zeros(ny, nx - 1), zeros(ny - 1, nx)

        two_eta_c = 2.0 * eta_c
        two_eta_n = 2.0 * self._eta_nodes(eta_c)
        # buoyancy at v-points (y-faces): T averaged vertically, edge-padded
        Tp = torch.cat([T_c[..., :1, :], T_c, T_c[..., -1:, :]], dim=-2)
        fy = self.raq * 0.5 * (Tp[..., :-1, :] + Tp[..., 1:, :])
        fy_int = fy[..., 1:-1, :]

        # viscosity-scaled local pseudo-steps (the JAX solver's constants)
        dtau_u = self.vsc * min(dx, dy) ** 2 / 4.1
        damp = 1.0 - self.vdamp / max(ny, nx)
        step_u = dtau_u / torch.maximum(eta_c[..., :, 1:], eta_c[..., :, :-1])
        step_v = dtau_u / torch.maximum(eta_c[..., 1:, :], eta_c[..., :-1, :])
        dtau_p = self.ptsc * 4.1 * eta_c / max(nx, ny)

        def divergence(u, v):
            return ((u[..., :, 1:] - u[..., :, :-1]) / dx
                    + (v[..., 1:, :] - v[..., :-1, :]) / dy)

        def momentum(u, v, p):
            """Momentum residuals on the interior faces."""
            exx = (u[..., :, 1:] - u[..., :, :-1]) / dx          # (ny, nx)
            eyy = (v[..., 1:, :] - v[..., :-1, :]) / dy          # (ny, nx)
            # shear at the nodes; free slip: zero du/dy, dv/dx on the walls
            du = F.pad(u[..., 1:, :] - u[..., :-1, :], (0, 0, 1, 1))
            dv = F.pad(v[..., :, 1:] - v[..., :, :-1], (1, 1, 0, 0))
            exy = 0.5 * (du / dy + dv / dx)                      # (ny+1, nx+1)
            txx = two_eta_c * exx - p
            tyy = two_eta_c * eyy - p
            txy = two_eta_n * exy
            Ru = ((txx[..., :, 1:] - txx[..., :, :-1]) / dx
                  + (txy[..., 1:, 1:-1] - txy[..., :-1, 1:-1]) / dy)
            Rv = ((tyy[..., 1:, :] - tyy[..., :-1, :]) / dy
                  + (txy[..., 1:-1, 1:] - txy[..., 1:-1, :-1]) / dx
                  + fy_int)
            return Ru, Rv

        # nondimensional error scales: momentum vs the buoyancy forcing,
        # divergence vs the velocity scale over one cell
        fscale = torch.clamp(_amax2(fy), min=1e-30)
        h_min = min(dx, dy)

        def err_pair(u, v, p):
            Ru, Rv = momentum(u, v, p)
            em = torch.maximum(_amax2(Ru), _amax2(Rv)) / fscale
            vmax = torch.clamp(torch.maximum(_amax2(u), _amax2(v)), min=1e-30)
            ed = _amax2(divergence(u, v)) * h_min / vmax
            return em, ed

        def iterate(n, u, v, p, dudt, dvdt):
            """n PT iterations; updates u and v in place (the solver owns
            them). The wall faces of u and v are never written, so they
            stay 0 (JAX stamps them every iteration)."""
            for _ in range(n):
                Ru, Rv = momentum(u, v, p)
                dudt = damp * dudt + Ru
                dvdt = damp * dvdt + Rv
                u[..., :, 1:-1] += step_u * dudt
                v[..., 1:-1, :] += step_v * dvdt
                p = p - dtau_p * divergence(u, v)
            return u, v, p, dudt, dvdt

        n_max = self.n_iter if n_iter is None else n_iter
        state = (u, v, p, dudt, dvdt)
        if self.ptol and self.ptol > 0:
            # chunks of check_every iterations while a member is above
            # ptol and within its budget; converged members are frozen
            chunk = max(1, min(self.check_every, n_max))
            err = T_c.new_full(lead, float("inf"))
            n_done = torch.zeros(lead, dtype=torch.int64, device=T_c.device)
            n_all = err.numel()
            while True:
                active = (err > self.ptol) & (n_done < n_max)
                n_active = int(active.sum())              # host read
                if n_active == 0:
                    break
                if n_active == n_all:
                    state = iterate(chunk, *state)
                else:
                    new = iterate(chunk, *(t.clone() for t in state))
                    keep = active.reshape(lead + (1, 1))
                    state = tuple(torch.where(keep, a, b)
                                  for a, b in zip(new, state))
                em, ed = err_pair(*state[:3])
                err = torch.where(active, torch.maximum(em, ed), err)
                n_done = n_done + chunk * active
        else:
            state = iterate(n_max, *state)
            n_done = torch.full(lead, n_max, dtype=torch.int64,
                                device=T_c.device)
        u, v, p = state[:3]
        err_mom, err_div = err_pair(u, v, p)

        # back to cell centres on the full grid, with BC stamping
        uf, vf, pf = zeros(ny + 2, nx + 2), zeros(ny + 2, nx + 2), \
            zeros(ny + 2, nx + 2)
        uf[..., 1:-1, 1:-1] = 0.5 * (u[..., :, 1:] + u[..., :, :-1])
        vf[..., 1:-1, 1:-1] = 0.5 * (v[..., 1:, :] + v[..., :-1, :])
        pf[..., 1:-1, 1:-1] = p - p.mean(dim=(-2, -1), keepdim=True)
        # replicate + antisymmetric stamping (pad_uvp semantics)
        uf[..., 0, 1:-1] = uf[..., 1, 1:-1]
        uf[..., -1, 1:-1] = uf[..., -2, 1:-1]
        vf[..., 1:-1, 0] = vf[..., 1:-1, 1]
        vf[..., 1:-1, -1] = vf[..., 1:-1, -2]
        return StokesResult(u=uf, v=vf, p=pf, err_mom=err_mom,
                            err_div=err_div, n_done=n_done)


class StokesFn:
    """``(T, V, uvp0=None) -> (u, v, p)`` batched solver for the engine's
    ``mode="GAIA"`` and ``mode="ML_PRE"``; T, V (B, H, W).

    With ``uvp0`` (the surrogate's (u, v, p), full-grid (B, H, W)) the
    solve warm-starts from it and runs ``pre_iter`` iterations: the
    reference's ML_PRE mode (advect_wi_gaia.py:221,488). ``n_done`` holds
    the PT iterations of the last call, per simulation (a device tensor).
    """

    def __init__(self, solver: PTStokesSolver, pre_iter: int):
        self.solver, self.pre_iter = solver, pre_iter
        self.n_done: Optional[torch.Tensor] = None

    def __call__(self, T, V, uvp0=None):
        T_c, V_c = T[..., 1:-1, 1:-1], V[..., 1:-1, 1:-1]
        if uvp0 is None:
            r = self.solver.solve(T_c, V_c)
        else:
            u0, v0, p0 = uvp0
            r = self.solver.solve(T_c, V_c, u0=u0[..., 1:-1, 1:-1],
                                  v0=v0[..., 1:-1, 1:-1],
                                  p0=p0[..., 1:-1, 1:-1],
                                  n_iter=self.pre_iter)
        self.n_done = r.n_done
        return r.u, r.v, r.p


def make_stokes_fn(grid, raq: float, n_iter: int = 2000,
                   pre_iter: Optional[int] = None) -> StokesFn:
    """The JAX package's ``make_stokes_fn``: a :class:`StokesFn` on
    ``grid`` with ``pre_iter`` defaulting to n_iter // 10."""
    solver = PTStokesSolver(
        ny=grid.H - 2, nx=grid.W - 2, dy=grid.dy,
        dx=grid.aspect / (grid.W - 2), raq=raq, n_iter=n_iter)
    if pre_iter is None:
        pre_iter = max(n_iter // 10, 1)
    return StokesFn(solver, pre_iter)
