"""Finite-difference stencils on ``[..., H, W]`` fields, as slices.

Counterpart of the JAX package's ``ops/stencils.py`` (reference:
pytorch_networks_convae.py:183-263). Each 3-tap operator reproduces the
output shape of the reference's VALID convolution: it shrinks its axis by
2. Row 0 is the hot bottom (y), the last axis is x.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dx_left(x):
    """Backward difference along x: out[i] = x[i+1] - x[i], width W-2."""
    return x[..., 1:-1] - x[..., :-2]


def dx_right(x):
    """Forward difference along x: out[i] = x[i+2] - x[i+1], width W-2."""
    return x[..., 2:] - x[..., 1:-1]


def dx_center(x):
    """Central difference along x: (x[i+2] - x[i]) / 2, width W-2."""
    return 0.5 * (x[..., 2:] - x[..., :-2])


def dy_top(x):
    """Backward difference along y, height H-2."""
    return x[..., 1:-1, :] - x[..., :-2, :]


def dy_bot(x):
    """Forward difference along y, height H-2."""
    return x[..., 2:, :] - x[..., 1:-1, :]


def dy_center(x):
    """Central difference along y, height H-2."""
    return 0.5 * (x[..., 2:, :] - x[..., :-2, :])


def du_dy(x):
    """4-tap cross kernel [1, -1, -1, 1]^T along y, height H-3
    (reference: pytorch_networks_convae.py:235-241)."""
    return x[..., :-3, :] - x[..., 1:-2, :] - x[..., 2:-1, :] + x[..., 3:, :]


def dv_dx(x):
    """4-tap cross kernel [1, -1, -1, 1] along x, width W-3
    (reference: pytorch_networks_convae.py:244-250)."""
    return x[..., :-3] - x[..., 1:-2] - x[..., 2:-1] + x[..., 3:]


def laplace(x):
    """5-point Laplacian, VALID: (H-2, W-2)
    (reference: pytorch_networks_convae.py:254-260)."""
    return (x[..., :-2, 1:-1] + x[..., 2:, 1:-1] + x[..., 1:-1, :-2]
            + x[..., 1:-1, 2:] - 4.0 * x[..., 1:-1, 1:-1])


def get_mass(u, v, bc: bool = False):
    """Velocity divergence du/dx + dv/dy on the interior, (H-2, W-2)
    (reference: pytorch_networks_convae.py:27-52). With ``bc`` the first
    and last columns of du/dx and rows of dv/dy are scaled by 2/1.5, the
    reference's one-sided boundary metric."""
    du_dx = dx_center(u)[..., 1:-1, :]
    dv_dy = dy_center(v)[..., :, 1:-1]
    if bc:
        edge_x = torch.ones(du_dx.shape[-1], dtype=u.dtype, device=u.device)
        edge_x[[0, -1]] = 2.0 / 1.5
        edge_y = torch.ones(dv_dy.shape[-2], dtype=v.dtype, device=v.device)
        edge_y[[0, -1]] = 2.0 / 1.5
        du_dx = du_dx * edge_x
        dv_dy = dv_dy * edge_y[:, None]
    return du_dx + dv_dy


def pad_grad(x, p=(1, 1, 1, 1)):
    """Linear-extrapolation pad by (left, right, last row side, row-0
    side): each new column or row extends the local gradient, e.g. left
    2·x[:, 0] - x[:, 1] (reference: pytorch_networks_convae.py:55-83,
    whose p[2] pads the last row and p[3] the first)."""
    for _ in range(p[0]):
        x = torch.cat((2.0 * x[..., :, 0:1] - x[..., :, 1:2], x), dim=-1)
    for _ in range(p[1]):
        x = torch.cat((x, 2.0 * x[..., :, -1:] - x[..., :, -2:-1]), dim=-1)
    for _ in range(p[2]):
        x = torch.cat((x, 2.0 * x[..., -1:, :] - x[..., -2:-1, :]), dim=-2)
    for _ in range(p[3]):
        x = torch.cat((2.0 * x[..., 0:1, :] - x[..., 1:2, :], x), dim=-2)
    return x


def replicate_pad(x, pad=(1, 1, 1, 1)):
    """Edge padding of the last two axes by (left, right, low-y, high-y)."""
    lead = x.shape[:-2]
    x4 = x.reshape((-1, 1) + tuple(x.shape[-2:]))
    y = F.pad(x4, tuple(pad), mode="replicate")
    return y.reshape(lead + tuple(y.shape[-2:]))


def _zero_corners(a):
    a[..., 0, 0] = 0.0
    a[..., 0, -1] = 0.0
    a[..., -1, 0] = 0.0
    a[..., -1, -1] = 0.0
    return a


def pad_uvp(u, v, p=None):
    """Boundary padding of interior (H-2, W-2) fields (reference:
    pytorch_networks_convae.py:145-178): u replicated in y and mirrored
    with a sign flip in x (free-slip sidewalls), v the transpose, p (when
    given) replicated; corners zeroed. Returns (u, v, p|None), each
    (H, W)."""
    u = replicate_pad(u, (0, 0, 1, 1))
    u = _zero_corners(torch.cat((-u[..., :, 0:1], u, -u[..., :, -1:]),
                                dim=-1))
    v = replicate_pad(v, (1, 1, 0, 0))
    v = _zero_corners(torch.cat((-v[..., 0:1, :], v, -v[..., -1:, :]),
                                dim=-2))
    if p is not None:
        p = _zero_corners(replicate_pad(p, (1, 1, 1, 1)))
    return u, v, p


def stamp_temperature_bc(T, bottom: float = 1.0, top: float = 0.0,
                         core_cool: bool = False):
    """Dirichlet top/bottom + Neumann (copy) sidewalls on ``[..., H, W]``
    (reference: pytorch_networks_convae.py:465-471). With ``core_cool``
    the bottom row is left as it is: it evolves (advect_wi_gaia.py:624-625).
    Returns a new tensor."""
    T = T.clone()
    if not core_cool:
        T[..., 0, :] = bottom
    T[..., -1, :] = top
    T[..., :, 0] = T[..., :, 1]
    T[..., :, -1] = T[..., :, -2]
    return T
