"""Curl heads: divergence-free velocities from a stream function.

Counterparts of ``curl_head_padded`` and ``curl_head_valid`` in the JAX
package's ``ops/curl.py``: u = ∂a/∂y, v = -∂a/∂x as VALID central
differences. The padded head (NewFluidNet, reference:
pytorch_networks_convae.py:1369-1386) replicate-pads them back to (H, W)
with antisymmetric free-slip sidewalls and zeroed corners; the valid head
(Transolver) returns them as they are.
"""

from __future__ import annotations

from .stencils import dx_center, dy_center, replicate_pad


def _zero_corners(x):
    """Zero the four corner cells of ``[..., H, W]`` in place."""
    x[..., 0, 0] = 0.0
    x[..., 0, -1] = 0.0
    x[..., -1, 0] = 0.0
    x[..., -1, -1] = 0.0
    return x


def curl_head_padded(a):
    """(…, H, W) stream function → (…, H, W) u, v."""
    u = replicate_pad(dy_center(a)[..., :, 1:-1])
    u[..., :, 0] = -u[..., :, 1]
    u[..., :, -1] = -u[..., :, -2]
    _zero_corners(u)

    v = replicate_pad(-dx_center(a)[..., 1:-1, :])
    v[..., 0, :] = -v[..., 1, :]
    v[..., -1, :] = -v[..., -2, :]
    _zero_corners(v)
    return u, v


def curl_head_valid(a):
    """Transolver curl head: (…, H, W) stream function → (…, H-2, W-2)
    u, v (reference: Transolver_Structured_Mesh_2D-checkpoint.py:201-204)."""
    return dy_center(a)[..., :, 1:-1], -dx_center(a)[..., 1:-1, :]
