"""Training losses: scaled/boundary-weighted L1, derivative loss,
mass-conservation penalties.

Counterpart of the JAX package's ``train/losses.py`` (reference: the
``Trainer``'s loss stack, multigpu.py:122-305). Every function is pure
and takes (B, H, W) fields.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.stencils import dx_center, dx_left, dy_center, dy_top


def l1(a, b):
    return torch.mean(torch.abs(a - b))


def scaled_boundary_l1(x_true, x_pred, loss_scale: bool = True):
    """Reference ``Trainer.loss_fn`` (multigpu.py:122-134).

    With ``loss_scale``: per-sample dynamic-range scaling
    clip(1/(max-min), 1, 10) and an 11× weight on the 2-cell boundary ring.
    Returns (weighted_loss, plain_l1).
    """
    plain = l1(x_true, x_pred)
    if not loss_scale:
        return plain, plain
    maxs = torch.amax(x_true, dim=(1, 2), keepdim=True)
    mins = torch.amin(x_true, dim=(1, 2), keepdim=True)
    scaler = torch.clamp(1.0 / (maxs - mins), 1.0, 10.0)
    bc = torch.full(x_true.shape[1:], 11.0, dtype=x_true.dtype,
                    device=x_true.device)
    bc[2:-2, 2:-2] = 1.0
    loss = torch.mean(torch.abs((x_true - x_pred) * scaler * bc))
    return loss, plain


def derivative_loss(u_true, u_pred, v_true, v_pred):
    """One-sided derivative matching terms, scaled by the interior layer
    count (the reference multiplies by 126 on the 128-row grid,
    multigpu.py:162-169). Returns (du-term, dv-term)."""
    n = u_true.shape[-2] - 2
    du_t = dy_top(u_true) * n
    du_p = dy_top(u_pred) * n
    dv_t = dx_left(v_true) * n
    dv_p = dx_left(v_pred) * n
    return l1(du_t, du_p), l1(dv_t, dv_p)


def mass_residual(u, v):
    """|du/dx + dv/dy| on the interior-cropped central stencil
    (multigpu.py:159-171)."""
    du_dx = dx_center(u)[..., 1:-1, :]
    dv_dy = dy_center(v)[..., :, 1:-1]
    return torch.abs(du_dx + dv_dy)


def mass_penalty(mass, loss_type: str):
    """"mass": full-field mean; "curl": boundary-only means
    (multigpu.py:184-192); else 0."""
    if loss_type == "mass":
        return torch.mean(mass)
    if loss_type == "curl":
        return (torch.mean(mass[..., :, 0]) + torch.mean(mass[..., :, -1])
                + torch.mean(mass[..., 0, :]) + torch.mean(mass[..., -1, :]))
    return torch.zeros((), dtype=mass.dtype, device=mass.device)


class LossBreakdown(NamedTuple):
    """[total, u, v, p, T, mass] — the reference's 6-column loss vector
    (multigpu.py:331-338)."""

    total: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor
    p: torch.Tensor
    T: torch.Tensor
    mass: torch.Tensor

    def stack(self) -> torch.Tensor:
        """The six columns as one (6,) tensor."""
        return torch.stack(tuple(self))


def fluidnet_loss(u, v, p, uvp_true, p_pred: bool = False,
                  loss_scale: bool = True, loss_derivative: bool = False,
                  loss_type: str = "curl") -> LossBreakdown:
    """Full fluidnet-family training loss (multigpu.py:136-194).

    uvp_true: (B, C, H, W) with channels (u, v[, p]).
    """
    u_true = uvp_true[:, 0]
    v_true = uvp_true[:, 1]
    loss_u, true_u = scaled_boundary_l1(u_true, u, loss_scale)
    loss_v, true_v = scaled_boundary_l1(v_true, v, loss_scale)

    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    if p_pred and p is not None:
        loss_p, _ = scaled_boundary_l1(uvp_true[:, 2], p, loss_scale)
    else:
        loss_p = zero

    if loss_derivative:
        d_u, d_v = derivative_loss(u_true, u, v_true, v)
        loss_u = loss_u + d_u
        loss_v = loss_v + d_v

    mass = mass_residual(u, v)
    if p_pred:
        loss = (loss_u + loss_v + loss_p) / 3.0
    else:
        loss = (loss_u + loss_v) / 2.0
    loss = loss + mass_penalty(mass, loss_type)

    return LossBreakdown(total=loss, u=true_u, v=true_v, p=loss_p, T=zero,
                         mass=torch.mean(mass))


def unet_loss(u, v, p, T, uvpt_true, p_pred: bool = False,
              loss_scale: bool = True, loss_derivative: bool = False,
              loss_type: str = "curl") -> LossBreakdown:
    """U-Net coupled loss (multigpu.py:196-305). uvpt_true channels:
    (u, v[, p], T)."""
    u_true = uvpt_true[:, 0]
    v_true = uvpt_true[:, 1]
    loss_u, true_u = scaled_boundary_l1(u_true, u, loss_scale)
    loss_v, true_v = scaled_boundary_l1(v_true, v, loss_scale)

    zero = torch.zeros((), dtype=u.dtype, device=u.device)
    if p_pred and p is not None:
        _, loss_p = scaled_boundary_l1(uvpt_true[:, 2], p, loss_scale)
        _, loss_T = scaled_boundary_l1(uvpt_true[:, 3], T, loss_scale)
    else:
        loss_p = zero
        _, loss_T = scaled_boundary_l1(uvpt_true[:, 2], T, loss_scale)

    if loss_derivative:
        d_u, d_v = derivative_loss(u_true, u, v_true, v)
        loss_u = loss_u + d_u
        loss_v = loss_v + d_v

    mass = mass_residual(u, v)
    if p_pred:
        loss = (loss_u + loss_v + loss_p + loss_T) / 4.0
    else:
        loss = (loss_u + loss_v + loss_T) / 3.0
    loss = loss + mass_penalty(mass, loss_type)

    return LossBreakdown(total=loss, u=true_u, v=true_v, p=loss_p,
                         T=loss_T, mass=torch.mean(mass))
