"""Curl head: divergence-free velocities from a stream function.

Counterpart of ``curl_head_padded`` in the JAX package's ``ops/curl.py``
(reference: pytorch_networks_convae.py:1369-1386): u = ∂a/∂y,
v = -∂a/∂x as VALID central differences, replicate-padded back to
(H, W), antisymmetric free-slip sidewalls and zeroed corners.
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
