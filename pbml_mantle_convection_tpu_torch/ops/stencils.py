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


def get_mass(u, v):
    """Velocity divergence du/dx + dv/dy on the interior, (H-2, W-2)
    (reference: pytorch_networks_convae.py:27-52, ``bc=False``)."""
    return dx_center(u)[..., 1:-1, :] + dy_center(v)[..., :, 1:-1]


def replicate_pad(x, pad=(1, 1, 1, 1)):
    """Edge padding of the last two axes by (left, right, low-y, high-y)."""
    lead = x.shape[:-2]
    x4 = x.reshape((-1, 1) + tuple(x.shape[-2:]))
    y = F.pad(x4, tuple(pad), mode="replicate")
    return y.reshape(lead + tuple(y.shape[-2:]))


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
